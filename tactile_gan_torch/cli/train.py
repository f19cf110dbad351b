"""Training CLI: ``python -m tactile_gan_torch.cli.train --data DIR``.

The flags of the repository's ``train.py`` plus ``--device`` (default cuda;
``--device cpu`` runs the plain PyTorch versions of the kernels). Reads
``{data}/train/source`` and writes final_model.pth, the five loss arrays
and params.txt into ``{work_root}/models/{folder_save}``. Under torchrun
it trains one rank of a parallel run (``--mesh_data``, ``--mesh_model``)
and only rank 0 prints and writes:

    torchrun --nproc_per_node N -m tactile_gan_torch.cli.train \
        --mesh_model M --data DIR
"""

from __future__ import annotations

import os


def main(argv=None, *, graphed: bool = True):
    """Train and save; returns the Trainer (its epoch times and state).
    ``graphed=False`` (a test hook, not a flag) runs the step eager on the
    card."""
    from tactile_gan_torch.core.config import config_from_args
    from tactile_gan_torch.data.dataset import PairedDataset
    from tactile_gan_torch.train.loop import Trainer

    cfg = config_from_args(argv)
    train_set = PairedDataset(os.path.join(cfg.data, "train", "source"),
                              size=cfg.image_size, mode="train",
                              target=cfg.target,
                              cache_decoded=cfg.cache_decoded,
                              aug=not cfg.no_aug)
    trainer = Trainer(cfg, train_set, graphed=graphed)
    save_path = trainer.run_and_save()
    if trainer.is_main_process:
        print(f"saved model + arrays + params to {save_path}")
    return trainer


if __name__ == "__main__":
    main()
