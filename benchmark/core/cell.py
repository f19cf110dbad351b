"""One run of a training cell: the port's ``Trainer`` (the path of
``tactile_gan_torch/cli/train.py``) on the cell's configuration and mix,
built from the seed, driven through its own epoch loop.

Set-up makes the chart pairs into a fresh directory under ``TMPDIR``,
builds the ``Trainer``, copies the weights made from the seed into its
networks (and the VGG tower's into its step), and runs the first
``warmup_epochs`` epochs through the trainer's own feed and step: the
eager first step, the CUDA graph's capture, the first replays and one
epoch boundary. The first three of those steps are the ones the output
check compares: their losses, the first gradient as Adam holds it after
step 1, step 2's gradients (the first replay of the graph) from Adam's
moments after steps 1 and 2 with the parameters they were taken at, and
each parameter's change after step 3, read before step 4. What the check
keeps is copied to the host at once, so none of it stays on the device.

The window opens at the next epoch's first batch and closes at the first
batch the trainer asks for once ``seconds`` have passed; the device is
synchronized at both ends. Everything in between counts: every step, the
waits for batches, each epoch's end (its loss means) and the next epoch's
feed starting up. The harness sits only between the trainer and its
prefetcher (``Trainer.prefetch``), where it times the wait for each batch
and opens and closes the window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import shutil
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

from benchmark.core.check import (
    Readings, STEPS, first_grads, host_copy, later_grads, leaf_norms,
)
from benchmark.core.spec import Cell
from benchmark.core.trace import Trace, from_profiler
from benchmark.core.weights import load_into, network_weights, vgg_weights
from benchmark.reference.follow import networks as reference_networks
from benchmark.traffic_gen.synth import write_dataset

# The port's Adam, parameter dtype and discriminator, which a configuration
# can only state.
FIXED = {"param_dtype": "float32", "beta2": 0.99, "adam_eps": 1e-8,
         "disc": "PatchGAN"}
DATA_WAIT_SPAN = "bench.data_wait"


class WindowClosed(Exception):
    pass


@dataclasses.dataclass
class Window:
    seconds: float  # from the first step's start to the synchronize after
    steps: int      # the last step begun in the window
    images: int
    setup_s: float
    data_wait_s: List[float]
    memory_peak_bytes: int
    nonfinite_epochs: int
    trace: Optional[Trace]


def train_config(cell: Cell, seed: int, data_dir: str, device: str):
    """The port's ``TrainConfig`` of the cell's configuration and mix."""
    from tactile_gan_torch.core.config import TrainConfig

    c, t = cell.config, cell.traffic
    for key, value in FIXED.items():
        if c[key] != value:
            raise ValueError(f"{c['name']}: {key} {c[key]!r}; the port runs "
                             f"{value!r} only")
    return TrainConfig(
        data=data_dir, batch_size=t["batch_size"], input_dim=c["input_dim"],
        output_dim=c["output_dim"], total_epochs=c["total_epochs"],
        epoch_constant=c["epoch_constant"], lr=c["lr"],
        no_label_smoothing=not c["label_smoothing"], beta1=c["beta1"],
        threads=t["threads"], lambda_a=c["lambda_a"],
        lambda_gp=c["lambda_gp"], lambda_per=t["lambda_per"],
        w_per=tuple(c["w_per"]), gen=c["gen"], nf=c["nf"], loss=c["loss"],
        version=t["version"], reg_every=t["reg_every"], seed=seed,
        compute_dtype=c["compute_dtype"], image_size=c["image_size"],
        host_aug=t["host_aug"], bf16_resident=c["bf16_resident"],
        disc_bf16=c["disc_bf16"], disc_same_pad=c["disc_same_pad"],
        device=device)


class TrainRun:
    def __init__(self, cell: Cell, seed: int, device: str,
                 t_start: float, seconds: float, trace: bool):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.t_start, self.seconds, self.tracing = t_start, seconds, trace
        self.cuda = self.device.type == "cuda"
        self.data_dir = ""
        self.trainer = None
        self.readings: Optional[Readings] = None

    # ---------------------------------------------------------------- set-up
    def setup(self) -> None:
        from tactile_gan_torch.data.dataset import PairedDataset
        from tactile_gan_torch.train.loop import Trainer

        cell, t = self.cell, self.cell.traffic
        mark = time.perf_counter()
        self.phases = {"imports": mark - self.t_start}

        def phase(name):
            nonlocal mark
            now = time.perf_counter()
            self.phases[name] = now - mark
            mark = now

        self.data_dir = tempfile.mkdtemp(prefix="bench_charts_")
        data = os.path.join(self.data_dir, "data")
        write_dataset(data, n_train=t["pairs"], n_test=0,
                      size=cell.config["image_size"], seed=self.seed)
        cfg = self.cfg = train_config(cell, self.seed, data,
                                      self.device.type)
        dataset = PairedDataset(self.img_dir(), size=cfg.image_size,
                                mode="train", target=cfg.target,
                                cache_decoded=cfg.cache_decoded,
                                aug=not cfg.no_aug)
        phase("charts")
        trainer = Trainer(cfg, dataset)
        phase("trainer")
        spe = trainer.steps_per_epoch * t["warmup_epochs"]
        if spe < STEPS + 1:
            raise ValueError(f"{spe} warm-up steps; the check needs "
                             f"{STEPS + 1}")
        self.ref_nets = dict(zip(("gen", "disc"), reference_networks(
            cell.config, "f32", "meta")))
        self.models = {"gen": (trainer.gen, trainer.state.opt_g),
                       "disc": (trainer.disc, trainer.state.opt_d)}
        for net, (model, _) in self.models.items():
            load_into(model, network_weights(self.ref_nets[net], self.seed,
                                             net, self.device))
        vgg = trainer.step_fn.vgg_params
        if vgg is not None:
            made = vgg_weights(self.seed, self.device, cfg.input_dim)
            with torch.no_grad():
                for name, tensor in vgg.items():
                    tensor.copy_(made[name])
        phase("weights")
        self.trainer = trainer
        self.prefetch = trainer.prefetch
        trainer.prefetch = self._feed
        self.step_losses: List[torch.Tensor] = []
        step = trainer._step

        def recorded(src, tgt, apply_gp):
            out = step(src, tgt, apply_gp)
            if len(self.step_losses) < STEPS:
                self.step_losses.append(out)
            return out

        trainer._step = recorded
        self.epochs = self.handed = 0
        self.t0 = None
        self.handed_at_t0 = 0
        self.waits: List[float] = []
        self.prof = None

    def img_dir(self) -> str:
        return os.path.join(self.cfg.data, "train", "source")

    # ------------------------------------------------------------- the feed
    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def _feed(self, batches):
        """Stands in for ``Trainer.prefetch``: yields the prefetcher's
        batches, times the wait for each and opens and closes the
        window."""
        opens = self.epochs == self.cell.traffic["warmup_epochs"]
        self.epochs += 1
        inner = self.prefetch(batches)
        try:
            while True:
                self._before_batch(opens)
                opens = False
                t = time.perf_counter()
                span = (torch.profiler.record_function(DATA_WAIT_SPAN)
                        if self.prof is not None
                        else contextlib.nullcontext())
                with span:
                    item = next(inner, None)
                if item is None:
                    return
                if self.t0 is not None:
                    self.waits.append(time.perf_counter() - t)
                self.handed += 1
                yield item
        finally:
            inner.close()
            if hasattr(batches, "close"):
                batches.close()

    def _moments(self, net: str):
        model, opt = self.models[net]
        return [(name, opt.state[p].get("exp_avg", torch.zeros_like(p)))
                for name, p in model.named_parameters()]

    def _before_batch(self, opens: bool) -> None:
        if self.handed == 1:  # step 1 (eager) is done
            self._sync()
            self.first_grads = {
                net: leaf_norms(first_grads(model, [
                    m for _, m in self._moments(net)], self.cfg.beta1))
                for net, (model, _) in self.models.items()}
            self.moments = {net: host_copy(self._moments(net))
                            for net in self.models}
            self.at = {net: host_copy(model.named_parameters())
                       for net, (model, _) in self.models.items()}
        elif self.handed == 2:  # step 2, the graph's first replay, is done
            self._sync()
            self.replay_grads = {
                net: later_grads(self.moments[net],
                                 host_copy(self._moments(net)),
                                 self.cfg.beta1)
                for net in self.models}
            self.at["disc_after"] = host_copy(
                self.models["disc"][0].named_parameters())
            self.moments = None
        elif self.handed == STEPS and self.readings is None:
            self._sync()
            change = {}
            for net, (model, _) in self.models.items():
                start = network_weights(self.ref_nets[net], self.seed, net,
                                        self.device)
                change[net] = leaf_norms({n: p - start[n] for n, p in
                                          model.named_parameters()})
                del start
            self.readings = Readings(
                torch.stack(self.step_losses).double().cpu().numpy(),
                self.first_grads, change, self.replay_grads, self.at)
        if opens:
            self._open()
        elif self.t0 is not None and \
                time.perf_counter() - self.t0 >= self.seconds:
            self._close()

    def _open(self) -> None:
        del self.trainer._step  # the recorder: back to the trainer's own
        self._sync()
        if self.tracing:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
        self.epochs_at_t0 = len(self.trainer.gen_loss)
        self.t0 = time.perf_counter()
        self.phases["warmup"] = self.t0 - self.t_start - sum(
            self.phases.values())
        self.handed_at_t0 = self.handed

    def _close(self) -> None:
        self._sync()
        self.t1 = time.perf_counter()
        raise WindowClosed

    # --------------------------------------------------------------- measure
    def measure(self) -> Window:
        try:
            self.trainer.train(progress=False)
            if self.t0 is None:
                raise RuntimeError("the run ended before its window opened")
            self._sync()
            self.t1 = time.perf_counter()
        except WindowClosed:
            pass
        peak = (torch.cuda.max_memory_allocated(self.device) if self.cuda
                else 0)
        steps = self.handed - self.handed_at_t0
        trace = None
        if self.prof is not None:
            self.prof.stop()
            trace = from_profiler(self.prof, self.t1 - self.t0, steps)
            self.prof = None
        tr = self.trainer
        means = np.array([tr.disc_loss, tr.gen_loss, tr.l1_loss, tr.gp_loss,
                          tr.per_loss], dtype=np.float64)[:,
                                                          self.epochs_at_t0:]
        return Window(seconds=self.t1 - self.t0, steps=steps,
                      images=steps * self.cfg.batch_size,
                      setup_s=self.t0 - self.t_start, data_wait_s=self.waits,
                      memory_peak_bytes=int(peak),
                      nonfinite_epochs=int(np.sum(~np.all(np.isfinite(means),
                                                          axis=0))),
                      trace=trace)

    def release(self) -> None:
        """Drop the program's state (its graphs and their memory)."""
        self.trainer = self.models = self.prefetch = None
        self.step_losses = []
        gc.collect()
        if self.cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def remove_data(self) -> None:
        if self.data_dir:
            shutil.rmtree(self.data_dir, ignore_errors=True)
