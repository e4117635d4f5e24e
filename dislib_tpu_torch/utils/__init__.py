"""Utilities (counterpart of ``dislib_tpu/utils``): ``shuffle`` and
``train_test_split``, model saving, host-read accounting, the ``dslib.*``
loggers."""

from dislib_tpu_torch.utils.base import shuffle, train_test_split
from dislib_tpu_torch.utils.saving import save_model, load_model

__all__ = ["shuffle", "train_test_split", "save_model", "load_model"]
