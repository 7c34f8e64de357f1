"""Command line of the PyTorch/CUDA port, with the flags of ``run.py``:

    python -m aadg_tpu_torch.run --cfg experiments/optic_sinkhorn/diversity.yaml \
        --mode search [--smoke_test] [--device cpu] [KEY VALUE ...]
    python -m aadg_tpu_torch.run --cfg ... --mode train \
        TPU.AUTOAUGMENT True TEST.MODEL_DIR <search run dir> [KEY VALUE ...]
    python -m aadg_tpu_torch.run --cfg ... --mode test \
        --output_type {seg,image} [--vis_dir DIR] TEST.MODEL_DIR <run dir>

It runs on the CUDA card unless ``--device cpu`` is given, and raises when
no card is visible and the CPU was not asked for. Both tasks run on the
synthetic pools: optic (``DATASET.NAME synthetic_optic``) and rvs
(``--cfg experiments/rvs_sinkhorn/diversity_ex.yaml DATASET.NAME
synthetic_rvs TPU.SYNTHETIC_SIZE 512``), SegFormer on the optic pools
with ``--cfg experiments/zoo/segformer_b4_optic.yaml DATASET.NAME
synthetic_optic``; the Fundus and RVS disk readers are not ported yet.
"""

from __future__ import annotations

import argparse

import torch

from .config import load_config


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Adversarial AutoAugment (PyTorch/CUDA port)")
    parser.add_argument("--mode", default="search",
                        help="[search / train / test]")
    parser.add_argument("--cfg", required=True, type=str,
                        help="experiment configuration filename")
    parser.add_argument("--output_dir", default="output", type=str)
    parser.add_argument("--vis_dir", default="vis", type=str)
    parser.add_argument("--output_type", default="image", type=str)
    parser.add_argument("--seed", default=1023, type=int)
    parser.add_argument("--data_parallel", default=-1, type=int,
                        help="devices for data parallelism (only 1 is "
                             "ported; -1 means 1 here)")
    parser.add_argument("--smoke_test", action="store_true",
                        help="tiny run: 2 epochs (1 warmup), 2 steps/epoch")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="config overrides: KEY VALUE ...")
    return parser.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    """The requested device; a CUDA request with no card raises instead of
    falling back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass --device cpu "
                           "to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return device


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.cfg, args.opts or None)
    cfg.OUTPUT_DIR = args.output_dir
    cfg.SEED = args.seed
    cfg.TPU.DATA_PARALLEL = args.data_parallel
    if args.smoke_test:
        cfg.TRAIN.WARMUP_EPOCH = 1
        cfg.TRAIN.END_EPOCH = 2
        cfg.TPU.STEPS_PER_EPOCH = 2
    cfg.freeze()

    if args.mode == "search":
        from .engine.search import run_search
        return run_search(cfg, args.cfg, device=device)
    if args.mode == "train":
        from .engine.train import run_train
        return run_train(cfg, args.cfg, device=device)
    if args.mode == "test":
        from .engine.test import run_test
        return run_test(cfg, args.cfg, vis_dir=args.vis_dir,
                        output_type=args.output_type, seed=args.seed,
                        device=device)
    raise NotImplementedError("Only [search / train / test] are supported.")


if __name__ == "__main__":
    main()
