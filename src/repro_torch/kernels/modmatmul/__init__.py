from .kernel import (  # noqa: F401
    modmatmul_blocks_plus_cuda,
    modmatmul_cuda,
    modmatmul_masked_cuda,
    modmatmul_rows_plus_cuda,
    reset_launch_counts,
)
from .ops import (  # noqa: F401
    autotune_tiles,
    mod_matmul,
    mod_matmul_blocks_plus,
    mod_matmul_crt,
    mod_matmul_masked,
    mod_matmul_rows_plus,
    padded_shape,
    padding_waste,
    pick_tiles,
    polyeval,
    polyeval_masked,
    register_tile_chooser,
    skinny_fuses,
)
from .ref import (  # noqa: F401
    modmatmul_blocks_plus_plain,
    modmatmul_masked_plain,
    modmatmul_ref,
    modmatmul_rows_plus_plain,
)
