"""The ds-array and its ingest (counterpart of ``dislib_tpu/data``)."""

from dislib_tpu_torch.data.array import (
    Array, array, random_array, zeros, full, ones, identity, eye,
    apply_along_axis, concat_rows, concat_cols, rechunk, ensure_canonical,
)
from dislib_tpu_torch.data.io import (
    load_txt_file, load_svmlight_file, load_npy_file, load_mdcrd_file,
    save_txt, QuarantineLedger, QuarantineReport, last_quarantine_report,
    quarantine_ledger, quarantine_batch,
)
from dislib_tpu_torch.data.sparse import SparseArray

__all__ = ["Array", "array", "random_array", "zeros", "full", "ones",
           "identity", "eye", "apply_along_axis", "concat_rows",
           "concat_cols", "rechunk", "ensure_canonical",
           "load_txt_file", "load_svmlight_file", "load_npy_file",
           "load_mdcrd_file", "save_txt", "QuarantineReport",
           "QuarantineLedger", "last_quarantine_report",
           "quarantine_ledger", "quarantine_batch", "SparseArray"]
