"""Training CLI: ``python -m tactile_gan_torch.cli.train --data DIR``.

The flags of the repository's ``train.py`` plus ``--device`` (default cuda;
``--device cpu`` runs the plain PyTorch versions of the kernels). Reads
``{data}/train/source`` and writes final_model.pth, the five loss arrays
and params.txt into ``{work_root}/models/{folder_save}``.
"""

from __future__ import annotations

import os


def main(argv=None):
    """Train and save; returns the Trainer (its epoch times and state)."""
    from tactile_gan_torch.core.config import config_from_args
    from tactile_gan_torch.data.dataset import PairedDataset
    from tactile_gan_torch.train.loop import Trainer

    cfg = config_from_args(argv)
    train_set = PairedDataset(os.path.join(cfg.data, "train", "source"),
                              size=cfg.image_size, mode="train",
                              target=cfg.target,
                              cache_decoded=cfg.cache_decoded,
                              aug=not cfg.no_aug)
    trainer = Trainer(cfg, train_set)
    save_path = trainer.run_and_save()
    print(f"saved model + arrays + params to {save_path}")
    return trainer


if __name__ == "__main__":
    main()
