from .crop import run_rand_crop

__all__ = ["run_rand_crop"]
