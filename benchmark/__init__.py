"""The benchmark of frame2frame_tpu_torch on an NVIDIA H100."""
