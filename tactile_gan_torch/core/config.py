"""Training configuration and the train CLI's flags.

Field names and defaults are those of ``tactile_gan_tpu/core/config.py``
(the reference CLI surface plus the JAX package's extensions), so a
``params.txt`` written by either package, or by the PyTorch reference,
rehydrates here and the other way round. Unknown keys are ignored.

The port adds ``device`` (cuda unless the caller asks for cpu).
``--profile_dir`` works as in the JAX package;
``--debug_nans`` checks each step's losses (not each operation, as
``jax_debug_nans`` does). ``--mesh_data`` / ``--mesh_model`` shape the mesh
of a parallel run and ``--ckpt_backend orbax`` writes its periodic
checkpoints with ``torch.distributed.checkpoint`` (``train/loop.py``).
Flags that only choose a TPU layout or kernel of the same function
(``--use_pallas``, ``--lane_pack``, ...) are accepted and ignored with a
one-line note.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import List, Optional

import torch

_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# Flags of the JAX package that only pick a TPU layout or kernel of the
# same function: accepted, ignored by the port.
TPU_ONLY_FLAGS = ("use_pallas", "force_pallas", "split_concat", "lane_pack",
                  "bf16_resident", "packed_row0", "gp_fused", "disc_bf16")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    data: str = "./data"
    batch_size: int = 4
    input_dim: int = 3
    output_dim: int = 3
    initial_epoch: int = 1
    total_epochs: int = 135
    epoch_constant: int = 25
    lr: float = 0.001
    no_label_smoothing: bool = False
    beta1: float = 0.9
    threads: int = 8
    lambda_a: float = 1.0
    lambda_gp: float = 0.01
    lambda_per: float = 1.0
    w_per: tuple = (0.0, 0.1, 0.3, 0.6)
    gen: str = "UNet++"
    nf: int = 64
    loss: str = "ls"
    no_aug: bool = False
    target: str = "rgb"
    version: int = 1
    folder_save: str = "pix2obj"
    folder_load: str = "pix2obj"
    checkpoint_interval: int = -1
    continue_training: bool = False
    reg_every: int = 1

    seed: int = 21
    compute_dtype: str = "bfloat16"
    image_size: int = 256
    drop_last: bool = True
    use_pallas: bool = True
    force_pallas: bool = False
    vgg_weights: str = ""
    mesh_data: int = 0
    mesh_model: int = 1
    legacy_label_cache: bool = False
    space_to_depth: bool = False
    lane_pack: Optional[bool] = None
    bf16_resident: Optional[bool] = None
    packed_row0: Optional[bool] = None
    split_concat: bool = True
    host_aug: bool = True
    cache_decoded: bool = True
    gp_fused: Optional[bool] = None
    disc_bf16: Optional[bool] = None
    disc_same_pad: bool = False
    profile_dir: str = ""
    debug_nans: bool = False
    ckpt_backend: str = "native"
    device: str = "cuda"

    @property
    def activation(self) -> bool:
        """Whether the generator head applies Tanh (and D its sigmoid):
        True only for 'ls' ('ce', 'w' and 'hinge' train activation-free)."""
        if self.loss in ("w", "hinge"):
            return False
        return self.loss != "ce"

    @property
    def label_smoothing(self) -> bool:
        return not self.no_label_smoothing

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        try:
            return _COMPUTE_DTYPES[self.compute_dtype]
        except KeyError:
            raise ValueError(
                f"compute_dtype must be one of {sorted(_COMPUTE_DTYPES)}, "
                f"got {self.compute_dtype!r}") from None

    @property
    def work_root(self) -> str:
        """The directory holding models/ and checkpoints/: the reference
        derives it as ``data.rsplit('/', 1)[0]``."""
        return self.data.rsplit("/", 1)[0] if "/" in self.data else "."

    def models_dir(self) -> str:
        return os.path.join(self.work_root, "models", self.folder_save)

    def to_params_dict(self) -> dict:
        """The reference's key set plus the extensions; w_per as a list,
        as argparse's nargs=4 gives it."""
        d = dataclasses.asdict(self)
        d["w_per"] = list(self.w_per)
        return d

    def save_params(self, folderpath: str, extra: Optional[dict] = None
                    ) -> None:
        """Write params.txt as one JSON object, like the reference;
        ``extra`` adds run-provenance keys that every reader ignores."""
        d = self.to_params_dict()
        if extra:
            d.update(extra)
        with open(os.path.join(folderpath, "params.txt"), "w") as f:
            f.write(json.dumps(d))

    @classmethod
    def from_params_file(cls, path: str) -> "TrainConfig":
        """Rehydrate from params.txt; unknown keys are ignored and missing
        ones keep their defaults."""
        with open(path) as f:
            raw = json.load(f)
        field_names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in raw.items() if k in field_names}
        if "w_per" in kwargs:
            kwargs["w_per"] = tuple(float(x) for x in kwargs["w_per"])
        return cls(**kwargs)


def build_arg_parser() -> argparse.ArgumentParser:
    """The train CLI of ``train.py``: the reference's flags, the JAX
    package's extensions, and ``--device``."""
    p = argparse.ArgumentParser()
    p.add_argument("--data", default="./data", help="dataset directory")
    p.add_argument("--batch_size", type=int, default=4, help="training batch size")
    p.add_argument("--input_dim", type=int, default=3, help="input depth size")
    p.add_argument("--output_dim", type=int, default=3, help="output depth size")
    p.add_argument("--initial_epoch", type=int, default=1,
                   help="starting epoch, useful when resuming a half-trained model")
    p.add_argument("--total_epochs", type=int, default=135,
                   help="total epochs to train for")
    p.add_argument("--epoch_constant", type=int, default=25,
                   help="epochs to keep the learning rate constant")
    p.add_argument("--lr", type=float, default=0.001, help="learning rate")
    p.add_argument("--no_label_smoothing", default=False, action="store_true",
                   help="disable one-sided label smoothing")
    p.add_argument("--beta1", type=float, default=0.9, help="Adam beta1")
    p.add_argument("--threads", type=int, default=8,
                   help="host threads for loading the dataset")
    p.add_argument("--lambda_a", type=float, default=1, help="L1 loss coefficient")
    p.add_argument("--lambda_gp", type=float, default=0.01,
                   help="gradient penalty coefficient")
    p.add_argument("--lambda_per", type=float, default=1,
                   help="perceptual loss coefficient")
    p.add_argument("--w_per", nargs=4, type=float, default=[0, 0.1, 0.3, 0.6],
                   help="perceptual weights")
    p.add_argument("--gen", default="UNet++", choices=["UNet++", "UNet", "BCDUNet"],
                   help="generator architecture")
    p.add_argument("--nf", type=int, default=64,
                   help="base filter count of the architectures")
    p.add_argument("--loss", default="ls", choices=["ls", "ce", "w", "hinge"],
                   help="GAN objective")
    p.add_argument("--no_aug", default=False, action="store_true",
                   help="disable dataset augmentation")
    p.add_argument("--target", default="rgb", choices=["ch", "rgb"],
                   help="target image format")
    p.add_argument("-v", "--version", type=int, default=1, choices=[1, 2],
                   help="tactile GAN version (selects the perceptual-loss variant)")
    p.add_argument("--folder_save", default="pix2obj", help="model save folder")
    p.add_argument("--folder_load", default="pix2obj", help="model load folder")
    p.add_argument("--checkpoint_interval", type=int, default=-1,
                   help="epochs between intermediate checkpoints (-1 = none)")
    p.add_argument("--continue_training", default=False, action="store_true",
                   help="load a checkpoint written by the port before training")
    p.add_argument("--reg_every", type=int, default=1,
                   help="apply gradient-penalty regularization on epochs divisible by this")
    p.add_argument("--seed", type=int, default=21, help="random seed")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"], help="conv compute dtype")
    p.add_argument("--image_size", type=int, default=256, help="square image size")
    p.add_argument("--vgg_weights", default="",
                   help="local .npz of pretrained VGG16 feature weights for "
                        "perceptual loss v1 (random-feature fallback if empty)")
    p.add_argument("--space_to_depth", default=False, action="store_true",
                   help="UNet++ variant: row 0 runs 2x2-folded (H/2 x W/2 x 2nf)")
    p.add_argument("--legacy_label_cache", default=False, action="store_true",
                   help="reference-exact cached label noise: one draw reused by "
                        "every step of the run")
    p.add_argument("--host_aug", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="flip/affine augmentation in the host decode pool "
                        "(--no-host_aug: on the device, inside the step)")
    p.add_argument("--cache_decoded", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="RAM-cache decoded images across epochs")
    p.add_argument("--disc_same_pad", default=False,
                   action=argparse.BooleanOptionalAction,
                   help="SAME-padding discriminator variant")
    p.add_argument("--ckpt_backend", default="native",
                   choices=["native", "orbax"],
                   help="periodic-checkpoint backend (orbax: sharded step "
                        "checkpoints through torch.distributed.checkpoint)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # TPU-only flags of the JAX package, accepted and ignored.
    for flag in ("use_pallas", "split_concat"):
        p.add_argument(f"--{flag}", default=True,
                       action=argparse.BooleanOptionalAction,
                       help="TPU-only; ignored by the port")
    p.add_argument("--force_pallas", default=False, action="store_true",
                   help="TPU-only; ignored by the port")
    for flag in ("lane_pack", "bf16_resident", "packed_row0", "gp_fused",
                 "disc_bf16"):
        p.add_argument(f"--{flag}", default=None,
                       action=argparse.BooleanOptionalAction,
                       help="TPU-only; ignored by the port")
    p.add_argument("--mesh_data", type=int, default=0,
                   help="data-parallel ranks (0: world size / mesh_model)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="tensor-parallel ranks that split the wide convs")
    p.add_argument("--profile_dir", default="",
                   help="write a torch.profiler trace of the first epoch "
                        "into this directory")
    p.add_argument("--debug_nans", default=False, action="store_true",
                   help="raise FloatingPointError after the first step "
                        "whose losses are not finite")
    return p


def config_from_args(argv: Optional[List[str]] = None) -> TrainConfig:
    p = build_arg_parser()
    args = p.parse_args(argv)
    d = vars(args).copy()
    d["w_per"] = tuple(d["w_per"])
    ignored = [f for f in TPU_ONLY_FLAGS if d[f] != p.get_default(f)]
    if ignored:
        print("note: TPU-only flags are ignored by the port: "
              + ", ".join(f"--{f}" for f in ignored))
    return TrainConfig(**d)
