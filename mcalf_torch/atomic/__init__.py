from mcalf_torch.atomic.data import (
    LineData,
    LineNotFoundError,
    available_lines,
    get_line,
    get_lines,
    load_atomfile,
    register_line,
)

__all__ = [
    "LineData",
    "LineNotFoundError",
    "available_lines",
    "get_line",
    "get_lines",
    "load_atomfile",
    "register_line",
]
