"""Utilities (counterpart of ``dislib_tpu/utils``): ``shuffle`` and
``train_test_split``, host-read accounting, the ``dslib.*`` loggers."""

from dislib_tpu_torch.utils.base import shuffle, train_test_split

__all__ = ["shuffle", "train_test_split"]
