"""DHM core and quantization of the port."""
