"""Data- and tensor-parallel training over ``torch.distributed``."""
