"""Native runtime components (C++), loaded via ctypes: the port's own copy
of the capture runtime's image decoder and prefetcher, built at first use
into the package's `_build/` directory."""

from libcml_tpu_torch.native.io import (
    NativePrefetcher,
    decode_gray,
    native_available,
    read_image_gray,
)

__all__ = ["NativePrefetcher", "decode_gray", "native_available", "read_image_gray"]
