"""The frozen chart generator: the same seed writes the same files, byte
for byte, and the copy writes what the port's generator writes today."""

import filecmp
import os

from benchmark.traffic_gen.synth import write_dataset


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same(a, b):
    names = _files(a)
    assert names == _files(b) and names
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors


def test_same_seed_same_bytes(tmp_path):
    write_dataset(str(tmp_path / "a"), n_train=3, n_test=1, size=64,
                  seed=2 ** 31 + 5)
    write_dataset(str(tmp_path / "b"), n_train=3, n_test=1, size=64,
                  seed=2 ** 31 + 5)
    _same(str(tmp_path / "a"), str(tmp_path / "b"))


def test_other_seed_other_charts(tmp_path):
    write_dataset(str(tmp_path / "a"), n_train=2, n_test=0, size=64, seed=1)
    write_dataset(str(tmp_path / "b"), n_train=2, n_test=0, size=64, seed=2)
    a = (tmp_path / "a" / "train" / "source" / "s_0000.png").read_bytes()
    b = (tmp_path / "b" / "train" / "source" / "s_0000.png").read_bytes()
    assert a != b


def test_copy_matches_the_port(tmp_path):
    from tactile_gan_torch.data.synth import write_dataset as port_write

    write_dataset(str(tmp_path / "copy"), n_train=4, n_test=2, size=128,
                  seed=7)
    port_write(str(tmp_path / "port"), n_train=4, n_test=2, size=128, seed=7)
    _same(str(tmp_path / "copy"), str(tmp_path / "port"))
