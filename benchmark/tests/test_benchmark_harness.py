"""The harness: pieces found by name from new files alone (a generator's
reference network too), the result line's keys, no result without a card,
the import check by whole top-level names, and BENCHMARK.json within the
limits of its format."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.core.runner import banned_modules, run
from benchmark.core.spec import load_cell, readers
from benchmark.tests.conftest import ROOT, shrink

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _tree_digest(root, leave_out=()):
    """sha256 of every file under ``root`` but ``.pyc`` files and the
    relative paths in ``leave_out``, with its path relative to ``root``."""
    h = hashlib.sha256()
    for d, _, files in sorted(os.walk(root)):
        for name in sorted(files):
            path = os.path.join(d, name)
            rel = os.path.relpath(path, root)
            if name.endswith(".pyc") or rel in leave_out:
                continue
            h.update(rel.encode())
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def test_new_pieces_are_found_by_name(tmp_path):
    """A configuration, a mix, a cell's limits and a per-layer metric, each
    a new file, and entries added to a copy of BENCHMARK.json: found by
    name and run, with no edit to a file that was there."""
    before = _tree_digest(os.path.join(ROOT, "benchmark"))
    root = tmp_path
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = _bench()
    bench["configs"].append({
        "name": "unetpp-nf8-small", "source": "test",
        "file": "benchmark/configs/unetpp-nf8-small.json", "reduced": [],
        "why": "test"})
    bench["workloads"].append({"name": "train.small.b2", "chips": 1,
                               "config": "unetpp-nf8-small",
                               "traffic": "b2-small", "why": "test"})
    bench["per_layer"].append({
        "name": "steps_in_window", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "train step",
        "moves": "train_img_per_s", "workloads": ["train.small.b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    config = shrink(load_cell(ROOT, "train.unetpp.b4")).config
    config["name"] = "unetpp-nf8-small"
    (root / "benchmark" / "configs" / "unetpp-nf8-small.json").write_text(
        json.dumps(config))
    traffic = dict(load_cell(ROOT, "train.unetpp.b4v2").traffic,
                   name="b2-small", pairs=8, batch_size=2, threads=2)
    (root / "benchmark" / "traffic" / "b2-small.json").write_text(
        json.dumps(traffic))
    shutil.copy(root / "benchmark" / "limits" / "train.unetpp.b4.json",
                root / "benchmark" / "limits" / "train.small.b2.json")
    (root / "benchmark" / "metrics" / "steps_in_window.py").write_text(
        "def read(reading):\n    return float(reading.window.steps)\n")

    cell = load_cell(str(root), "train.small.b2")
    assert cell.config["nf"] == 8 and cell.traffic["version"] == 2
    assert "steps_in_window" in readers(str(root), cell)
    # The existing cells do not report the new metric (its workloads key).
    assert "steps_in_window" not in readers(
        str(root), load_cell(str(root), "train.unetpp.b4"))
    result, _ = run(str(root), cell, 5, 0.5, True, "cpu", 0.0)
    assert result["metrics"]["steps_in_window"]["value"] == \
        result["attempted"] / 2
    assert _tree_digest(os.path.join(ROOT, "benchmark")) == before


# Run in a checkout copied with the new files: the copy's harness, the
# port from the repository, whose factory builds its UNet++ under the new
# name for this process alone.
_TWIN_RUN = """
import json, os
import torch
torch.set_num_threads(4)
import benchmark
from tactile_gan_torch.models import factory
factory.GENERATORS["unetpp-twin"] = factory.UNetPlusPlus
from benchmark.core.runner import run
from benchmark.core.spec import load_cell
from benchmark.reference.networks import find
root = os.getcwd()
result, lines = run(root, load_cell(root, "train.twin.b2"), 2 ** 31 + 5,
                    0.5, False, "cpu", 0.0)
print(json.dumps({"correct": result["correct"], "lines": lines,
                  "harness": benchmark.__file__,
                  "network": find("UNetPP-twin", "gen").path}))
"""


def test_new_generator_is_one_new_file(tmp_path):
    """A generator's reference network as one new file under
    ``reference/networks/`` (UNet++'s, under a new ``NAME``), with a
    configuration, a mix and limits of its own: found by name and run
    correct, with no edit to a file that was there."""
    before = _tree_digest(os.path.join(ROOT, "benchmark"))
    root = tmp_path
    bench_dir = root / "benchmark"
    shutil.copytree(os.path.join(ROOT, "benchmark"), bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    nets = bench_dir / "reference" / "networks"
    source = (nets / "unetpp.py").read_text()
    assert 'NAME = "UNet++"' in source
    added = {
        "reference/networks/unetpp_twin.py": source.replace(
            'NAME = "UNet++"', 'NAME = "UNetPP-twin"'),
        "configs/unetpp-twin-nf8.json": json.dumps(dict(
            shrink(load_cell(ROOT, "train.unetpp.b4v2")).config,
            name="unetpp-twin-nf8", gen="UNetPP-twin")),
        "traffic/b2-twin.json": json.dumps(dict(
            load_cell(ROOT, "train.unetpp.b4v2").traffic, name="b2-twin",
            pairs=8, batch_size=2, threads=2)),
    }
    for rel, text in added.items():
        (bench_dir / rel).write_text(text)
    shutil.copy(bench_dir / "limits" / "train.unetpp.b4v2.json",
                bench_dir / "limits" / "train.twin.b2.json")
    added["limits/train.twin.b2.json"] = ""
    bench = _bench()
    bench["configs"].append({
        "name": "unetpp-twin-nf8", "source": "test",
        "file": "benchmark/configs/unetpp-twin-nf8.json", "reduced": [],
        "why": "test"})
    bench["workloads"].append({"name": "train.twin.b2", "chips": 1,
                               "config": "unetpp-twin-nf8",
                               "traffic": "b2-twin", "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, "-c", _TWIN_RUN], cwd=root,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["harness"].startswith(str(root))
    assert out["network"] == str(nets / "unetpp_twin.py")
    assert out["correct"] is True, out["lines"]
    assert _tree_digest(str(bench_dir), leave_out=set(added)) == before
    assert _tree_digest(os.path.join(ROOT, "benchmark")) == before


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys(trace, tiny_cell):
    cell = tiny_cell("train.unetpp.b4v2")
    result, lines = run(ROOT, cell, 7, 0.5, bool(trace), "cpu", 0.0)
    keys = list(result)
    extra = ["breakdown"] if trace else []
    assert keys == RESULT_KEYS + extra + ["readings", "phases", "checks"]
    assert keys[-1] == "checks"
    want = ([m["name"] for m in cell.end_to_end] if not trace else
            ["data_wait_ms", "step_mfu"])  # no device trace on the CPU
    assert sorted(result["metrics"]) == sorted(want)
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    if trace:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, c in result["checks"].items():
        assert set(c) == {"value", "limit"}
        assert any(line.startswith(f"check {name} ") for line in lines)
    json.dumps(result)


def test_no_card_no_result(capsys):
    import torch

    from benchmark.run import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    rc = main(["--workload", "train.unetpp.b4", "--seed", "1",
               "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0
    assert out == ""
    assert "CUDA" in err


def test_import_check_by_whole_top_level_names():
    names = ["jax.numpy", "tactile_gan_tpu.ops", "tactile_gan_torch.ops",
             "tactile_gan_torch", "jaxlib.xla_client", "flaxen", "jaxtyping",
             "numpy"]
    assert banned_modules(names) == ["jax", "jaxlib", "tactile_gan_tpu"]
    assert banned_modules(["tactile_gan_torch.train.loop"]) == []


def test_benchmark_json_within_its_format():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and os.path.isfile(
            os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("benchmark/")
        assert isinstance(c["reduced"], list) and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert isinstance(key, str) and NAME.match(key)
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    cells = set()
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs
        assert (w["config"], w["traffic"]) not in cells
        cells.add((w["config"], w["traffic"]))
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        load_cell(ROOT, w["name"])  # its mix and limits exist
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert [m["name"] for m in bench["end_to_end"]] == ["train_img_per_s",
                                                        "setup_s"]
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert m["moves"] == "train_img_per_s" and "\n" not in m["layer"]
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "metrics",
                                           m["name"] + ".py"))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(bench)) < 64 * 1024
