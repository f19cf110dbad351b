"""The serving programs (``tactile_gan_torch/eval/graph.py``) against the
JAX runner's compiled ones (``_jits_for``, ``_chain_for``): each mode and
the two-step chain on the same weights at float32 compute; who owns the
programs and when they die; ``TACTILE_EVAL_TIMING``; a padded tail. On the
CPU each program runs its function eagerly, as the port does for a forward
on the CPU; the card's graphs are held to the eager programs by
``chip_smoke.py``."""

import gc
import os
import re
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tactile_gan_tpu.data.dataset import PairedDataset as JaxPairedDataset
from tactile_gan_tpu.eval import runner as jax_runner
from tactile_gan_tpu.models.factory import (
    create_generator as jax_create_generator,
)
from tactile_gan_tpu.utils.checkpoint import load_checkpoint, restore_partial

from test_torch_eval import _write_model_folder, _write_pairs
from test_torch_two_step import _stage

from tactile_gan_torch.data.dataset import PairedDataset
from tactile_gan_torch.eval import graph
from tactile_gan_torch.eval import runner

torch.set_num_threads(2)

SIZE, BATCH, N = 32, 2, 3


def _jax_forward(path, cfg):
    """The JAX runner's ``load_model`` forward (``tactile_gan_tpu/eval/
    runner.py:38-66``) with its parameter template from ``jax.eval_shape``:
    the template's values are all replaced from the checkpoint, and its
    op-by-op init takes 15-40 s on this CPU."""
    gen = jax_create_generator(cfg.gen, output_dim=cfg.output_dim,
                               nf=cfg.nf, activation=True,
                               compute_dtype=jnp.dtype(cfg.compute_dtype),
                               use_pallas=False)
    shapes = jax.eval_shape(gen.init, jax.random.key(0),
                            jnp.zeros((1, SIZE, SIZE, cfg.input_dim)))
    ckpt = load_checkpoint(path)
    params = restore_partial(
        jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes),
        {"params": ckpt["gen"].get("params", ckpt["gen"])})

    @jax.jit
    def forward(src_f32):
        return gen.apply(params, src_f32)

    return forward


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """A UNet++ nf 4 folder (float32 compute) with 3 test pairs, loaded by
    the port (on the CPU) and by the JAX package."""
    root = str(tmp_path_factory.mktemp("serve"))
    cfg = _write_model_folder(root, nf=4, size=SIZE, n=N)
    path = os.path.join(root, "models", "m", "final_model.pth")
    return {"root": root, "cfg": cfg, "path": path,
            "port": runner.load_model(path, cfg, device="cpu")[0],
            "jax": _jax_forward(path, cfg)}


def _batch(seed, shape=(BATCH, SIZE, SIZE, 3)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, shape, dtype=np.uint8),
            rng.integers(0, 256, shape, dtype=np.uint8))


def _port(programs, mode, src, tgt):
    return [t.numpy() for t in programs(
        mode, torch.from_numpy(src),
        torch.from_numpy(tgt) if mode == "u8_eval" else None)]


def _jax(jits, mode, src, tgt):
    args = (jnp.asarray(src),) + ((jnp.asarray(tgt),) if mode == "u8_eval"
                                  else ())
    res = jits[mode](*args)
    return [np.asarray(r) for r in (res if mode == "u8_eval" else (res,))]


def _check_programs(programs, jits, src, tgt, f32_atol):
    """Each mode of ``programs`` against the JAX programs ``jits``: float32
    outputs within ``f32_atol``; the uint8 output equal to the JAX
    quantize of the port's own float32 output (one rounding of the same
    array); the sums within 1e-5 relative (JAX sums in float32, the port
    in float64)."""
    f32 = _port(programs, "f32", src, tgt)[0]
    want = _jax(jits, "f32", src, tgt)[0]
    assert f32.shape == (BATCH, SIZE, SIZE, 3) and f32.dtype == np.float32
    np.testing.assert_allclose(f32, want, rtol=0, atol=f32_atol)
    quantized = np.asarray(jax_runner._quantize_u8(jnp.asarray(f32)))
    (u8,) = _port(programs, "u8", src, tgt)
    np.testing.assert_array_equal(u8, quantized)
    u8e, sums = _port(programs, "u8_eval", src, tgt)
    np.testing.assert_array_equal(u8e, quantized)
    jax_sums = _jax(jits, "u8_eval", src, tgt)[1]
    assert sums.shape == (BATCH, 4) and sums.dtype == np.float64
    np.testing.assert_allclose(sums, jax_sums, rtol=1e-5)


def test_programs_match_jax_jits(model):
    src, tgt = _batch(1)
    # float32 compute on both sides; convolutions and norms summed in
    # another order.
    _check_programs(model["port"].programs(), jax_runner._jits_for(
        model["jax"]), src, tgt, f32_atol=2e-5)


def test_chain_program_matches_jax_chain(tmp_path):
    root = str(tmp_path)
    port, jax = [], []
    for folder, target, seed in (("s1", "rgb", 3), ("s2", "ch", 5)):
        cfg = _stage(root, folder, target, seed)
        path = os.path.join(root, "models", folder, "final_model.pth")
        port.append(runner.load_model(path, cfg, device="cpu")[0])
        jax.append(_jax_forward(path, cfg))
    src, tgt = _batch(2)
    # Stage 2 instance-normalizes stage 1's output, which magnifies stage
    # 1's float32 differences: 5x the one-stage limit.
    _check_programs(runner.ChainedForward(*port).programs(),
                    jax_runner._jits_for(jax_runner._chain_for(*jax)),
                    src, tgt, f32_atol=1e-4)


def test_programs_check_their_arguments(model):
    programs = model["port"].programs()
    src, tgt = (torch.from_numpy(a) for a in _batch(3))
    with pytest.raises(ValueError, match="unknown serving program"):
        programs("f16", src)
    with pytest.raises(ValueError, match="target"):
        programs("u8_eval", src)
    with pytest.raises(ValueError, match="target"):
        programs("u8", src, tgt)


# ---------------------------------------------------------------------------
# Ownership: the programs belong to their forward and die with it.
# ---------------------------------------------------------------------------

def _dataset(root, target="rgb"):
    return PairedDataset(os.path.join(root, "test", "source"), size=SIZE,
                         mode="test", target=target)


def test_programs_are_owned_by_their_forward(model, tmp_path):
    cfg, path = model["cfg"], model["path"]
    forward = runner.load_model(path, cfg, device="cpu")[0]
    programs = forward.programs()
    assert forward.programs() is programs
    for shape in ((1, SIZE, SIZE, 3), (BATCH, SIZE, SIZE, 3)):
        src, tgt = (torch.from_numpy(a) for a in _batch(4, shape))
        for _ in range(2):
            for mode in graph.MODES:
                programs(mode, src, tgt if mode == "u8_eval" else None)
    assert len(programs.programs) == 2 * len(graph.MODES)
    assert programs.captures == 0  # the CPU runs the programs eagerly

    # test_model serves through the forward's programs: one program for the
    # run's mode and padded shape, none added by a second run.
    fresh = runner.load_model(path, cfg, device="cpu")[0]
    ds = _dataset(os.path.join(model["root"], "data"))
    for k in range(2):
        runner.test_model(fresh, ds, os.path.join(str(tmp_path), str(k)),
                          evaluation=True, eval_batch=BATCH, threads=2)
        assert list(fresh.programs().programs) == [
            ("u8_eval", ((BATCH, SIZE, SIZE, 3), torch.uint8),
             ((BATCH, SIZE, SIZE, 3), torch.uint8))]
    assert fresh.programs() is not programs

    ref = weakref.ref(programs)
    del forward, programs
    gc.collect()
    assert ref() is None


def test_chain_programs_are_reused_and_die_with_either_stage(tmp_path):
    root = str(tmp_path)
    cfgs = [_stage(root, "s1", "rgb", 3), _stage(root, "s2", "ch", 5)]
    _write_pairs(os.path.join(root, "charts"), n=N, size=SIZE, target="ch")
    ds = _dataset(os.path.join(root, "charts"), target="ch")

    def load(k):
        folder = ("s1", "s2")[k]
        return runner.load_model(os.path.join(root, "models", folder,
                                              "final_model.pth"), cfgs[k],
                                 device="cpu")[0]

    for dying in (0, 1):
        stages = [load(0), load(1)]
        for k in range(2):
            runner.test_two_step(*stages, ds, os.path.join(root, f"o{k}"),
                                 threads=2)
            chain = stages[0].chain_programs(stages[1])
            assert len(chain.programs) == 1
            if k == 0:
                first = chain
            assert chain is first  # a second call captures nothing
        assert stages[0].programs() is not chain
        assert runner.ChainedForward(*stages).programs() is chain
        ref = weakref.ref(chain)
        del chain, first
        del stages[dying]
        gc.collect()
        assert ref() is None, f"the chain outlived stage {dying + 1}"


# ---------------------------------------------------------------------------
# TACTILE_EVAL_TIMING and the padded tail.
# ---------------------------------------------------------------------------

_TIMING = re.compile(r"^\[eval timing\] n=(\d+) wall/img=\d+\.\d ms \| "
                     r"per-img ms: ((?:\w+=\d+\.\d ?)+)$")


def _timing_names(text):
    lines = [ln for ln in text.splitlines() if ln.startswith("[eval timing]")]
    assert len(lines) == 1, lines
    m = _TIMING.match(lines[0])
    assert m, lines[0]
    return int(m.group(1)), [p.split("=")[0] for p in m.group(2).split()]


def test_eval_timing_prints_the_jax_stages(model, tmp_path, monkeypatch,
                                           capsys):
    monkeypatch.setenv("TACTILE_EVAL_TIMING", "1")
    src_dir = os.path.join(model["root"], "data", "test", "source")
    capsys.readouterr()
    jax_runner.test_model(model["jax"], JaxPairedDataset(
        src_dir, size=SIZE, mode="test"), os.path.join(str(tmp_path), "jax"),
        evaluation=True, threads=2)
    want = _timing_names(capsys.readouterr().out)
    runner.test_model(model["port"], _dataset(os.path.join(
        model["root"], "data")), os.path.join(str(tmp_path), "port"),
        evaluation=True, threads=2)
    got = _timing_names(capsys.readouterr().out)
    assert got == want == (N, sorted(
        ["decode", "h2d_src", "h2d_tgt", "dispatch", "wait_staging",
         "wait_drain", "d2h_out", "d2h_sums", "write"]))
    monkeypatch.delenv("TACTILE_EVAL_TIMING")
    runner.test_model(model["port"], _dataset(os.path.join(
        model["root"], "data")), os.path.join(str(tmp_path), "quiet"),
        evaluation=True, threads=2)
    assert "[eval timing]" not in capsys.readouterr().out


def _files(out_dir):
    found = {}
    for sub in ("out", "sgt"):
        for name in sorted(os.listdir(os.path.join(out_dir, sub))):
            with open(os.path.join(out_dir, sub, name), "rb") as f:
                found[f"{sub}/{name}"] = f.read()
    with open(os.path.join(out_dir, "eval.txt"), "rb") as f:
        found["eval.txt"] = f.read()
    return found


def test_padded_tail_writes_the_same_artifacts(model, tmp_path):
    """eval_batch 2 over 3 pairs (the last batch padded with a copy of its
    pair) against eval_batch 1: every PNG and eval.txt byte for byte.

    On the CPU the batch shape alone moves float32 outputs by ulps, and so
    eval.txt's last digits (``tests/test_torch_eval.py``): oneDNN, the
    default conv, blocks a batch of 2 otherwise than a batch of 1, and a
    reduction over one image splits across threads otherwise. With oneDNN
    off and one thread each image is computed alone, so only the runner's
    batching is left to differ."""
    ds = _dataset(os.path.join(model["root"], "data"))
    written = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for b in (1, BATCH):
            out_dir = os.path.join(str(tmp_path), f"b{b}")
            with torch.backends.mkldnn.flags(enabled=False):
                res = runner.test_model(model["port"], ds, out_dir,
                                        evaluation=True, eval_batch=b,
                                        threads=2)
            runner.report_evaluation(*res, out_dir)
            written[b] = _files(out_dir)
    finally:
        torch.set_num_threads(threads)
    assert len(written[1]) == 2 * N + 1
    assert written[BATCH] == written[1]


class _OrderedPrograms:
    """Stands in for a forward's programs: the first call 'captures', each
    later call waits (up to 5 s) for the staging of the next batch to
    start, and records whether it did."""

    def __init__(self, started):
        self.started, self.calls, self.seen = started, 0, []

    def will_capture(self, mode, src_u8, tgt_u8=None):
        return self.calls == 0

    def __call__(self, mode, src_u8, tgt_u8=None):
        ci, self.calls = self.calls, self.calls + 1
        nxt = self.started.get(ci + 1)
        if nxt is not None:
            self.seen.append(nxt.is_set() if ci == 0 else nxt.wait(5.0))
        return (torch.zeros(src_u8.shape, dtype=torch.uint8),)


def test_staging_runs_one_batch_ahead_except_at_capture(tmp_path):
    """The upload of batch k+1 is submitted before batch k's dispatch, as
    the JAX runner does; only a dispatch that captures goes first, since
    nothing else may touch the card while it does."""
    import threading

    n = 4
    started = {i: threading.Event() for i in range(n)}
    programs = _OrderedPrograms(started)

    class Dataset:
        def __len__(self):
            return n

        def load_pair(self, i):
            started[i].set()
            img = np.full((8, 8, 3), 10 * i, np.uint8)
            return img, img

    class Forward:
        device = torch.device("cpu")

        def programs(self):
            return programs

    runner.test_model(Forward(), Dataset(), str(tmp_path), threads=2)
    # Batch 1 staged after the capturing dispatch of batch 0; batches 2
    # and 3 staged while batches 1 and 2 were dispatched.
    assert programs.seen == [False, True, True]
