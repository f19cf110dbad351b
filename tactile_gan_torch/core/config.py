"""The subset of the training configuration that serving reads.

Field names and defaults are those of ``tactile_gan_tpu/core/config.py``
(the reference CLI surface), so a ``params.txt`` written by either package,
or by the PyTorch reference, rehydrates here. Unknown keys are ignored.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
    # A network variant of the JAX package that the port does not build yet;
    # read so that load_model can refuse such a checkpoint.
    space_to_depth: bool = False

    @property
    def activation(self) -> bool:
        """Whether the generator head applies Tanh: True only for 'ls'
        ('ce', 'w' and 'hinge' train activation-free)."""
        if self.loss in ("w", "hinge"):
            return False
        return self.loss != "ce"

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        try:
            return _COMPUTE_DTYPES[self.compute_dtype]
        except KeyError:
            raise ValueError(
                f"compute_dtype must be one of {sorted(_COMPUTE_DTYPES)}, "
                f"got {self.compute_dtype!r}") from None

    def save_params(self, folderpath: str) -> None:
        """Write params.txt as one JSON object, like the reference."""
        d = dataclasses.asdict(self)
        d["w_per"] = list(self.w_per)
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
