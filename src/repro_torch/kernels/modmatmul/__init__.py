from .kernel import (  # noqa: F401
    modmatmul_cuda,
    modmatmul_masked_cuda,
    reset_launch_counts,
)
from .ops import (  # noqa: F401
    mod_matmul,
    mod_matmul_masked,
    padded_shape,
    padding_waste,
    pick_tiles,
    polyeval,
    polyeval_masked,
    register_tile_chooser,
)
from .ref import modmatmul_masked_plain, modmatmul_ref  # noqa: F401
