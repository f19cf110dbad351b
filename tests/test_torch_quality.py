"""cli/quality.py, the port's scripts/quality_run.sh: the training and
serving argv it builds against the script's own (the script run by bash
with a stand-in ``python`` that records its arguments), the whole flow at a
small size on the CPU, and its refusal of a card this host lacks."""

import json
import math
import os
import stat
import subprocess
import tempfile

import numpy as np
import pytest
import torch

from tactile_gan_torch.cli import quality
from tactile_gan_torch.eval.runner import can_plot
from tactile_gan_torch.train.graph import LAUNCH_COUNTERS

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "quality_run.sh")

# The script's header configs (its environment knobs) and cli.quality's
# flags for each.
CONFIGS = {
    "BATCH=4  VERSION=2": ({"BATCH": "4", "VERSION": "2"},
                           ["--batch", "4", "--version", "2"]),
    "BATCH=16 VERSION=2": ({"BATCH": "16", "VERSION": "2"},
                           ["--batch", "16", "--version", "2"]),
    "BATCH=4  VERSION=1 LAMBDA_PER=1": (
        {"BATCH": "4", "VERSION": "1", "LAMBDA_PER": "1"},
        ["--batch", "4", "--version", "1", "--lambda_per", "1"]),
}

RECORDER = """#!/bin/sh
# Stands in for python: records its arguments, one per line; as test.py
# (--folder TAG --work_root WORK) it writes the eval.txt the script cats.
printf '%s\\n' "$@" > "$RECORD_DIR/$(basename "$1").argv"
if [ "$1" = test.py ]; then
  mkdir -p "$5/Outputs/$3" && echo recorded > "$5/Outputs/$3/eval.txt"
fi
"""


def _script_calls(tmp_path, env_knobs):
    """Run scripts/quality_run.sh with ``python`` recording its argv: the
    train.py and test.py argument lists (script name dropped)."""
    bin_dir, work = tmp_path / "bin", tmp_path / "work"
    bin_dir.mkdir()
    (work / "data" / "train" / "source").mkdir(parents=True)
    python = bin_dir / "python"
    python.write_text(RECORDER)
    python.chmod(python.stat().st_mode | stat.S_IEXEC)
    env = {"PATH": f"{bin_dir}:/usr/bin:/bin", "WORK": str(work),
           "RECORD_DIR": str(tmp_path), **env_knobs}
    subprocess.run(["bash", SCRIPT], env=env, check=True,
                   capture_output=True, timeout=60)
    calls = {}
    for name in ("train.py", "test.py"):
        argv = (tmp_path / f"{name}.argv").read_text().splitlines()
        calls[name] = argv[1:]
    return str(work), calls


def _drop(argv, flags):
    out, it = [], iter(argv)
    for a in it:
        if a in flags:
            next(it)
        else:
            out.append(a)
    return out


@pytest.mark.parametrize("header", sorted(CONFIGS))
def test_train_and_test_argv_are_the_scripts(tmp_path, header):
    with open(SCRIPT) as f:
        assert header in f.read()  # a config of the script's header
    knobs, flags = CONFIGS[header]
    work, calls = _script_calls(tmp_path, knobs)
    args = quality.parse_args(flags + ["--work", work])
    ours = quality.train_argv(args)
    assert ours[:2] == ["--data", os.path.join(work, "data")]
    assert calls["train.py"][:2] == ["--data", f"{work}/data"]
    assert (_drop(ours, {"--data", "--seed", "--device"})
            == _drop(calls["train.py"], {"--data"}))
    assert ours[-4:] == ["--seed", "21", "--device", "cuda"]
    assert _drop(quality.serve_argv(args), {"--device"}) == calls["test.py"]


def test_the_flow_writes_every_artifact_and_one_json_line(tmp_path, capsys):
    work = str(tmp_path / "q")
    res = quality.main(["--epochs", "2", "--batch", "2", "--device", "cpu",
                        "--work", work], nf=4, size=64, n_train=8, n_test=4)
    out = capsys.readouterr().out.splitlines()
    lines = [json.loads(s) for s in out if s.startswith("{")]
    assert lines == [json.loads(json.dumps(res))]
    tag = "quality_b2_v2"
    out_dir = os.path.join(work, "Outputs", tag)
    with open(os.path.join(out_dir, "eval.txt")) as f:
        eval_txt = f.read().splitlines()
    assert len(eval_txt) == 3 and out[-4:-1] == eval_txt
    assert all(math.isfinite(res[k]) for k in ("dice", "accuracy", "jaccard"))
    assert res["config"] == {"batch": 2, "version": 2, "epochs": 2,
                             "lambda_per": None, "tag": tag, "nf": 4,
                             "size": 64, "n_train": 8, "n_test": 4}
    assert res["seed"] == 21 and res["device"] == "cpu"
    assert res["steps"] == 8 and len(res["l1_curve"]) == 2
    assert [res["l1_first"], res["l1_last"]] == res["l1_curve"]
    assert res["train_s"] > 0 and res["eval_s"] > 0
    assert res["launches_per_step"] == {  # plain versions on the CPU
        name: 0.0 for _, name in LAUNCH_COUNTERS}
    with open(os.path.join(work, "data", quality.STAMP)) as f:
        assert json.load(f) == {"n_train": 8, "n_test": 4, "size": 64,
                                "seed": 0}
    model_dir = os.path.join(work, "models", tag)
    for name in ("final_model.pth", "params.txt", "genloss.npy",
                 "discloss.npy", "l1loss.npy", "perloss.npy", "gploss.npy"):
        assert os.path.exists(os.path.join(model_dir, name)), name
    np.testing.assert_array_equal(
        np.load(os.path.join(model_dir, "l1loss.npy")), res["l1_curve"])
    for sub in ("out", "sgt"):
        assert len(os.listdir(os.path.join(out_dir, sub))) == 4
    assert os.path.isdir(os.path.join(out_dir, "elm"))
    if can_plot():
        for name in ("loss", "accuracy_dist", "dice_dist", "jaccard_dist"):
            assert os.path.exists(os.path.join(out_dir, f"{name}.png")), name
    assert len(os.listdir(os.path.join(work, "data", "train", "source"))) == 8


def test_cuda_on_a_host_without_a_card_raises_and_prints_nothing(
        tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    work = str(tmp_path / "q")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quality.main(["--device", "cuda", "--work", work], nf=4, size=64,
                     n_train=8, n_test=4)
    assert not any(s.startswith("{") for s in
                   capsys.readouterr().out.splitlines())
    assert not os.path.exists(work)


@pytest.mark.parametrize("stamp", [None, {"n_train": 96, "n_test": 16,
                                          "size": 256, "seed": 0}])
def test_a_chart_set_of_another_run_is_refused(tmp_path, capsys, stamp):
    work = tmp_path / "q"
    (work / "data" / "train" / "source").mkdir(parents=True)
    if stamp is not None:
        (work / "data" / quality.STAMP).write_text(json.dumps(stamp))
    with pytest.raises(ValueError, match="chart set"):
        quality.main(["--device", "cpu", "--work", str(work)], nf=4, size=64,
                     n_train=8, n_test=4)
    assert not any(s.startswith("{") for s in
                   capsys.readouterr().out.splitlines())
    assert not (work / "models").exists()


def test_the_default_work_root_is_under_the_temporary_directory(
        tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    args = quality.parse_args([])
    assert args.work == os.path.join(str(tmp_path), "quality_run")
