"""Two-step chained inference CLI: ``python -m
tactile_gan_torch.cli.two_step_test --s1_dir A --s2_dir B --data D``.

The flags of the repository's ``two_step_test.py`` plus ``--device``
(default cuda; ``--device cpu`` runs the plain PyTorch versions of the
kernels). Stage 1 maps the source to the RGB tactile image, stage 2 maps
that to the channel-wise one; stage 2's params.txt drives the dataset.
Writes Outputs/{s1}+{s2}_{data}/{out,sgt,elm}/ and eval.txt (with the
distribution plots where matplotlib is installed).
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--s1_dir", default="t1_2d_per")
    parser.add_argument("--s2_dir", default="t2_2d_per")
    parser.add_argument("--data", default="data_plot_3")
    parser.add_argument("--work_root", default=os.getcwd())
    parser.add_argument("--eval_batch", type=int, default=1,
                        help="chained forward batch (1 = the reference's "
                             "per-image loop; larger batches for throughput)")
    parser.add_argument("--eval_transfer", choices=("u8", "f32"),
                        default="u8",
                        help="device->host transfer mode (see cli.test)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from tactile_gan_torch.core.config import TrainConfig
    from tactile_gan_torch.data.dataset import PairedDataset
    from tactile_gan_torch.eval.runner import (
        load_model, report_evaluation, test_two_step,
    )
    from tactile_gan_torch.utils.io import mkdir

    root = args.work_root
    forwards, cfgs = [], []
    for folder in (args.s1_dir, args.s2_dir):
        cfg = TrainConfig.from_params_file(os.path.join(
            root, "models", folder.split("/")[-1], "params.txt"))
        forward, _ = load_model(os.path.join(root, "models", cfg.folder_save,
                                             "final_model.pth"), cfg,
                                device=args.device)
        forwards.append(forward)
        cfgs.append(cfg)

    # Stage 2's flags drive the dataset (reference two_step_test.py:67-68).
    dataset = PairedDataset(os.path.join(root, args.data, "test", "source"),
                            size=cfgs[1].image_size, mode="test",
                            target=cfgs[1].target)
    output_path = os.path.join(root, "Outputs",
                               f"{args.s1_dir}+{args.s2_dir}_{args.data}")
    mkdir(output_path)
    accuracy, dice, jaccard = test_two_step(
        forwards[0], forwards[1], dataset, output_path, evaluation=True,
        eval_batch=args.eval_batch, transfer=args.eval_transfer)
    if accuracy:
        report_evaluation(accuracy, dice, jaccard, output_path)
    return accuracy, dice, jaccard


if __name__ == "__main__":
    main()
