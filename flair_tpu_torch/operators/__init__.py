"""Degradation operators: SVD SRConv for the x8/x16 bicubic tasks, the
FFT null-space PseudoSR for the gaussian/jpeg tasks, and the
patch-average SuperResolution with DDRM's Λ-operators."""

from .factory import get_operator, make_restore_fn, make_restore_fn_p
from .pseudo_sr import PseudoSR, PseudoSRConf, get_pseudo_sr_conf
from .svd_ops import AFunctions, SRConv, SuperResolution
