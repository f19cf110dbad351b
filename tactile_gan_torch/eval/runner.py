"""Test-time runner: the ``test.py --folder`` flow of the JAX package
(``tactile_gan_tpu/eval/runner.py``) on PyTorch.

Kept from the reference, as the JAX package keeps them:
- the test loader builds the generator with Tanh on whatever the training
  loss was (``load_model(..., activation=None)``);
- checkpoint loading is partial (``load_state_dict(strict=False)``); a
  folder the JAX package trained (msgpack ``final_model.pth``) is read
  too.

Per batch the device runs one serving program (``eval/graph.py``, the
JAX runner's ``_jits_for``): normalize the uint8 upload, the generator, the
uint8 quantize (float64, bit-exact with the host writers' ``_u8``) and the
four fuzzy-metric sums (float64). On the card each program is a CUDA graph,
captured once per (forward, mode, eval batch) and replayed for every batch;
the forward owns its programs. Host work is pipelined: a decode pool, a
one-worker staging pool that uploads batch k+1 while batch k runs, a
one-worker device-to-host drain, and a pool of PNG writers.
``TACTILE_EVAL_TIMING=1`` prints the host time of each stage, as the JAX
runner does.

``test_two_step`` runs two loaded generators chained (``ChainedForward``,
one program for the whole chain) through the same loop, as
``two_step_test.py`` does.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
import threading
import time
import weakref
from collections import defaultdict, deque
from typing import List, Optional, Tuple

import numpy as np
import torch

from tactile_gan_torch.core.config import TrainConfig
from tactile_gan_torch.core.device import DEFAULT_DEVICE, resolve_device
from tactile_gan_torch.data.dataset import PairedDataset
from tactile_gan_torch.eval.graph import (  # noqa: F401 -- the runner's names
    ServingPrograms, fuzzy_sums, normalize_u8, quantize_u8,
)
from tactile_gan_torch.eval.metrics import eval_pair
from tactile_gan_torch.eval.visualize import (
    can_plot, compose_channels, concat_images, plot_loss, print_evaluation,
    to_pil, write_evaluation,
)
from tactile_gan_torch.models.blocks import init_weights
from tactile_gan_torch.models.factory import create_generator
from tactile_gan_torch.models.vgg import fallback_banner
from tactile_gan_torch.utils.checkpoint import (
    is_torch_checkpoint, load_checkpoint,
)
from tactile_gan_torch.utils.io import mkdir


class GeneratorForward:
    """The loaded generator as a callable on NHWC float32 batches that lie
    on ``device``; runs under inference mode, eagerly (it is what the
    serving programs capture).

    It owns its serving programs: ``programs()`` for the generator alone,
    ``chain_programs(second)`` for it chained before ``second``'s. Both
    die with the forward; a chain's die with either stage."""

    def __init__(self, gen: torch.nn.Module, device: torch.device):
        self.gen = gen
        self.device = device
        self._programs: Optional[ServingPrograms] = None
        # Keyed weakly by stage 2; a value holds the two generators, never
        # a forward, so an entry expires with stage 2.
        self._chains = weakref.WeakKeyDictionary()

    def __call__(self, src_f32: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.gen(src_f32)

    def programs(self) -> ServingPrograms:
        if self._programs is None:
            self._programs = ServingPrograms(self.gen, self.device)
        return self._programs

    def chain_programs(self, second: "GeneratorForward") -> ServingPrograms:
        progs = self._chains.get(second)
        if progs is None:
            progs = ServingPrograms(torch.nn.Sequential(self.gen, second.gen),
                                    self.device)
            self._chains[second] = progs
        return progs


def load_model(model_path: str, cfg: TrainConfig,
               activation: Optional[bool] = None,
               device=DEFAULT_DEVICE) -> Tuple[GeneratorForward,
                                               torch.nn.Module]:
    """Build the generator and restore its weights from final_model.pth.

    ``activation=None`` keeps the reference test loader's always-Tanh head.
    The file may be the port's or the JAX package's (msgpack). Parameters
    missing from a torch checkpoint keep a seeded N(0, 0.02) init, the
    reference's ``strict=False``; a JAX checkpoint must hold every one (its
    names are converted, so a miss means a conversion that found nothing).
    """
    dev = resolve_device(device)
    act = True if activation is None else activation
    gen = create_generator(cfg.gen, input_dim=cfg.input_dim,
                           output_dim=cfg.output_dim, nf=cfg.nf,
                           activation=act,
                           compute_dtype=cfg.torch_compute_dtype,
                           space_to_depth=cfg.space_to_depth)
    init_weights(gen, torch.Generator().manual_seed(0))
    missing = gen.load_state_dict(load_checkpoint(model_path)["gen"],
                                  strict=False).missing_keys
    if missing and not is_torch_checkpoint(model_path):
        raise KeyError(f"{model_path}: the JAX checkpoint has no value for "
                       f"{len(missing)} generator parameters, e.g. "
                       f"{missing[:4]}")
    gen.to(dev).eval()
    return GeneratorForward(gen, dev), gen


class ChainedForward:
    """Two loaded generators chained, stage 2 on stage 1's output as it
    comes (Tanh, [-1, 1]): the reference's two-step inference. Both must
    lie on one device."""

    def __init__(self, forward1: GeneratorForward,
                 forward2: GeneratorForward):
        if forward1.device != forward2.device:
            raise ValueError(f"the two stages lie on {forward1.device} and "
                             f"{forward2.device}; load both on one device")
        self.forward1, self.forward2 = forward1, forward2
        self.device = forward1.device
        self.gen = torch.nn.Sequential(forward1.gen, forward2.gen)

    def __call__(self, src_f32: torch.Tensor) -> torch.Tensor:
        return self.forward2(self.forward1(src_f32))

    def programs(self) -> ServingPrograms:
        """The whole chain as one program a mode, kept on stage 1: a new
        ``ChainedForward`` on the same pair captures nothing."""
        return self.forward1.chain_programs(self.forward2)


def load_arrays(path: str) -> dict:
    return {k: np.load(os.path.join(path, f"{k}loss.npy"))
            for k in ("gen", "disc", "l1", "gp", "per")}


def metrics_from_sums(s) -> dict:
    s_min, s_r, s_or, s_sq = (float(v) for v in s)
    return {"accuracy": s_min / s_r, "dice": 2.0 * s_or / s_sq,
            "jaccard": s_or / (s_sq - s_or)}


def _write_case(i: int, src: np.ndarray, tgt: np.ndarray, out: np.ndarray,
                output_path: str, target_mode: str) -> None:
    if target_mode == "rgb":
        b_img, out_img = to_pil(tgt), to_pil(out)
    else:
        b_img, out_img = compose_channels(tgt), compose_channels(out)
    out_img.save(os.path.join(output_path, "out", f"{i + 1}.png"))
    src_img = to_pil(src) if src.dtype == np.uint8 else to_pil(src / 2.0 + 0.5)
    concat_images(src_img, b_img, out_img).save(
        os.path.join(output_path, "sgt", f"{i + 1}.png"))
    if target_mode != "rgb":
        b_elm = concat_images(*[to_pil(tgt[:, :, c:c + 1]) for c in range(3)])
        o_elm = concat_images(*[to_pil(out[:, :, c:c + 1]) for c in range(3)])
        concat_images(b_elm, o_elm, mode="v").save(
            os.path.join(output_path, "elm", f"{i + 1}.png"))


def to_host(t: torch.Tensor) -> np.ndarray:
    """A device tensor as a host array (blocks until it is computed)."""
    return t.cpu().numpy()


def test_model(forward, dataset, output_path: str,
               evaluation: bool = False, target_mode: str = "rgb",
               eval_batch: int = 1, threads: int = 4, transfer: str = "u8",
               graphed: bool = True
               ) -> Tuple[List[float], List[float], List[float]]:
    """Run every pair of ``dataset`` and write out/, sgt/ (and elm/ for
    'ch'). ``eval_batch`` > 1 batches the forward and pads the tail by
    repeating its last pair (one program shape a run); metrics and
    artifacts are the same either way.

    ``transfer`` picks what comes back to the host: "u8" quantizes on the
    device and returns the metric sums; "f32" returns the float32 outputs
    and computes metrics and quantization on the host in float64.
    ``forward`` is a ``GeneratorForward`` or a ``ChainedForward``; its
    programs serve the batches. ``graphed=False`` runs the same programs
    eagerly on the card (the reference the graphs are held to)."""
    if transfer not in ("u8", "f32"):
        raise ValueError(f"unknown eval transfer mode: {transfer!r}")
    # TACTILE_EVAL_TIMING=1: host seconds of each stage (threads included),
    # printed per image at the end, in the JAX runner's names and format.
    timing = defaultdict(float) if os.environ.get("TACTILE_EVAL_TIMING") \
        else None
    timing_lock = threading.Lock()

    def timed(label, fn, *a):
        if timing is None:
            return fn(*a)
        t0 = time.perf_counter()
        res = fn(*a)
        with timing_lock:
            timing[label] += time.perf_counter() - t0
        return res

    for sub in ("out", "sgt", "elm"):
        mkdir(os.path.join(output_path, sub))
    accuracy, dice, jaccard = [], [], []
    n = len(dataset)
    if n == 0:
        return accuracy, dice, jaccard
    chunks = [list(range(s, min(s + eval_batch, n)))
              for s in range(0, n, eval_batch)]
    want_sums = transfer == "u8" and evaluation
    mode = "u8_eval" if want_sums else transfer
    dev = forward.device
    programs = (forward.programs() if graphed else
                ServingPrograms(forward.gen, dev, graphed=False))

    def pad(arrs):
        stacked = np.stack(arrs)
        if len(arrs) < eval_batch:
            stacked = np.concatenate(
                [stacked, np.repeat(stacked[-1:], eval_batch - len(arrs), 0)])
        return stacked

    def upload(arr):
        return torch.from_numpy(arr).to(dev)

    # CPU-bound pools never exceed the core count.
    host_par = max(1, min(threads, os.cpu_count() or threads))
    with cf.ThreadPoolExecutor(max_workers=host_par) as decode, \
            cf.ThreadPoolExecutor(max_workers=1) as staging, \
            cf.ThreadPoolExecutor(max_workers=1) as d2h, \
            cf.ThreadPoolExecutor(max_workers=host_par) as worker:

        def assemble(idxs):
            # The staging thread uploads into tensors of its own; the
            # program copies them into its static inputs.
            pairs = timed("decode",
                          lambda: list(decode.map(dataset.load_pair, idxs)))
            tgt = (timed("h2d_tgt", upload, pad([p[1] for p in pairs]))
                   if want_sums else None)
            return idxs, pairs, timed("h2d_src", upload,
                                      pad([p[0] for p in pairs])), tgt

        writes, metrics = [], []

        def drain(idxs, pairs, dev_out, dev_sums=None):
            outs = timed("d2h_out", to_host, dev_out)
            sums = (timed("d2h_sums", to_host, dev_sums)
                    if dev_sums is not None else None)
            for k, i in enumerate(idxs):
                out, tgt_u8 = outs[k], pairs[k][1]
                if evaluation:
                    if sums is not None:
                        metrics.append(metrics_from_sums(sums[k]))
                    else:
                        metrics.append(worker.submit(
                            eval_pair, tgt_u8.astype(np.float32) / 255.0, out))
                writes.append(worker.submit(
                    timed, "write", _write_case, i, pairs[k][0], tgt_u8, out,
                    output_path, target_mode))

        t_start = time.perf_counter()
        pending = staging.submit(assemble, chunks[0])
        drains = deque()
        for ci in range(len(chunks)):
            idxs, pairs, src_u8, tgt_u8 = timed("wait_staging",
                                                pending.result)
            # Staging runs one batch ahead of the dispatch, except while a
            # dispatch captures: nothing else may touch the card then.
            ahead = ci + 1 < len(chunks)
            after = ahead and programs.will_capture(mode, src_u8, tgt_u8)
            if ahead and not after:
                pending = staging.submit(assemble, chunks[ci + 1])
            # The program's outputs are tensors of their own (cloned after
            # the replay, on its stream, which the drain's copy follows).
            outs = timed("dispatch", programs, mode, src_u8, tgt_u8)
            if after:
                pending = staging.submit(assemble, chunks[ci + 1])
            drains.append(d2h.submit(drain, idxs, pairs, *outs))
            while len(drains) > 4:  # cap live device output buffers
                timed("wait_drain", drains.popleft().result)
        for f in drains:
            timed("wait_drain", f.result)
        for f in metrics:
            res = f.result() if isinstance(f, cf.Future) else f
            accuracy.append(float(res["accuracy"]))
            dice.append(float(res["dice"]))
            jaccard.append(float(res["jaccard"]))
        for w in writes:
            w.result()
        if timing is not None:
            wall = time.perf_counter() - t_start
            parts = " ".join(f"{k}={v * 1e3 / n:.1f}"
                             for k, v in sorted(timing.items()))
            print(f"[eval timing] n={n} wall/img={wall * 1e3 / n:.1f} ms | "
                  f"per-img ms: {parts}", flush=True)
    return accuracy, dice, jaccard


def test_two_step(forward1: GeneratorForward, forward2: GeneratorForward,
                  dataset, output_path: str, evaluation: bool = True,
                  eval_batch: int = 1, threads: int = 4, transfer: str = "u8"
                  ) -> Tuple[List[float], List[float], List[float]]:
    """``test_model`` on the chained generators, written channel-wise
    (``target_mode="ch"``: out/, sgt/ and elm/)."""
    return test_model(ChainedForward(forward1, forward2), dataset,
                      output_path, evaluation=evaluation, target_mode="ch",
                      eval_batch=eval_batch, threads=threads,
                      transfer=transfer)


def report_evaluation(accuracy, dice, jaccard, output_path: str) -> None:
    """eval.txt and the printed means, with the distribution plots where
    matplotlib is installed."""
    report = print_evaluation if can_plot() else write_evaluation
    report(accuracy, dice, jaccard, output_path)


def evaluate_folder(folder: str, work_root: str = ".",
                    data_override: Optional[str] = None,
                    eval_batch: int = 1, transfer: str = "u8",
                    device=DEFAULT_DEVICE, graphed: bool = True
                    ) -> Optional[dict]:
    """The test.py flow: params.txt, model, data and loss arrays; the loss
    plot; the run; eval.txt and the distribution plots.

    On a host without matplotlib the plots are skipped with a note; every
    other artifact is written as usual. ``graphed`` is ``test_model``'s."""
    params_path = os.path.join(work_root, "models", folder.split("/")[-1],
                               "params.txt")
    cfg = TrainConfig.from_params_file(params_path)
    # The model and loss arrays live under the params.txt-recorded
    # folder_save, which may differ from the --folder argument.
    model_dir = os.path.join(work_root, "models", cfg.folder_save)
    with open(params_path) as f:
        if json.load(f).get("vgg_random_fallback"):
            print("NOTE: params.txt records vgg_random_fallback=true — this "
                  "model was trained against deterministic random VGG "
                  "features.")
            print(fallback_banner())

    forward, _ = load_model(os.path.join(model_dir, "final_model.pth"), cfg,
                            device=device)
    data_dir = data_override or cfg.data
    dataset = PairedDataset(os.path.join(work_root, data_dir, "test", "source"),
                            size=cfg.image_size, mode="test",
                            target=cfg.target)
    output_path = os.path.join(work_root, "Outputs", cfg.folder_save)
    mkdir(output_path)
    plots = can_plot()
    if plots:
        plot_loss(load_arrays(model_dir), cfg.initial_epoch, cfg.total_epochs,
                  output_path)
    else:
        print("NOTE: matplotlib is not installed; loss.png and the metric "
              "distribution plots are not written.")

    accuracy, dice, jaccard = test_model(
        forward, dataset, output_path, evaluation=True,
        target_mode=cfg.target, eval_batch=eval_batch,
        threads=max(1, min(cfg.threads, 8)), transfer=transfer,
        graphed=graphed)
    if accuracy:
        report_evaluation(accuracy, dice, jaccard, output_path)
        return {"accuracy": float(np.mean(accuracy)),
                "dice": float(np.mean(dice)),
                "jaccard": float(np.mean(jaccard))}
    return None
