"""Degradation operators: SVD SRConv for the x8/x16 bicubic tasks."""

from .factory import get_operator, make_restore_fn, make_restore_fn_p
from .svd_ops import AFunctions, SRConv
