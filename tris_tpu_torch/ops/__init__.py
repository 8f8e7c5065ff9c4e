from tris_tpu_torch.ops.normalize import image_input_to_f32
from tris_tpu_torch.ops.resize import (
    bilinear_resize,
    interp_taps,
    nearest_resize,
)
