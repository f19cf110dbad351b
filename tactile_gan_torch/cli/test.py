"""Inference/eval CLI: ``python -m tactile_gan_torch.cli.test --folder X``.

The flags of the repository's ``test.py`` plus ``--device`` (default cuda;
``--device cpu`` runs the plain PyTorch versions of the kernels). Writes
Outputs/{folder_save}/{out,sgt,elm}/, loss.png, eval.txt and the metric
distribution plots.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--folder", default="pix2obj",
                        help="model folder (under ./models) containing params.txt")
    parser.add_argument("--work_root", default=os.getcwd(),
                        help="directory holding models/ and Outputs/")
    parser.add_argument("--data", default=None,
                        help="optional dataset-dir override")
    parser.add_argument("--eval_batch", type=int, default=1,
                        help="generator forward batch (1 = the reference's "
                             "per-image loop; larger batches for throughput)")
    parser.add_argument("--eval_transfer", choices=("u8", "f32"),
                        default="u8",
                        help="what crosses device->host: 'u8' quantizes "
                             "outputs and sums the metrics on the device; "
                             "'f32' returns full-precision outputs")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from tactile_gan_torch.eval.runner import evaluate_folder
    return evaluate_folder(args.folder, work_root=args.work_root,
                           data_override=args.data,
                           eval_batch=args.eval_batch,
                           transfer=args.eval_transfer, device=args.device)


if __name__ == "__main__":
    main()
