from repro_torch.kernels.stream_conv.ops import (
    stream_conv2d,
    stream_conv_block,
    stream_conv_pyramid,
)
from repro_torch.kernels.stream_conv.ref import (
    stream_conv2d_ref,
    stream_conv_block_ref,
    stream_conv_pyramid_ref,
)

__all__ = [
    "stream_conv2d",
    "stream_conv_block",
    "stream_conv_pyramid",
    "stream_conv2d_ref",
    "stream_conv_block_ref",
    "stream_conv_pyramid_ref",
]
