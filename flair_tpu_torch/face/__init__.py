"""Face prior: host-side alignment geometry, on-device crop / fuse / paste."""

from .helper import (
    FFHQ_TEMPLATE_512,
    MASK_COLORMAP,
    FaceRestoreHelper,
    estimate_similarity_transform,
    get_largest_face,
    make_face_fn,
    make_face_fn_p,
)
