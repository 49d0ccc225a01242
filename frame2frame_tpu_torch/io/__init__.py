from .flo import TAG_FLOAT, read_flo, write_flo
from .image import (
    is_tiff,
    read_frame,
    read_gray,
    read_image,
    read_pgm,
    write_gray,
    write_pgm,
)
from .video import load_video_dir, load_video_frames, save_video

__all__ = [
    "TAG_FLOAT",
    "read_flo",
    "write_flo",
    "is_tiff",
    "read_frame",
    "read_gray",
    "read_image",
    "read_pgm",
    "write_gray",
    "write_pgm",
    "load_video_dir",
    "load_video_frames",
    "save_video",
]
