"""Package setup for frame2frame_tpu (pip-installable counterpart of the
reference's setup.py packaging of lib/frame2frame)."""

from pathlib import Path

from setuptools import find_packages, setup

long_description = Path(__file__).with_name("README.md").read_text()

setup(
    name="frame2frame_tpu",
    version="0.1.0",
    description="TPU-native JAX framework for model-blind video denoising "
    "(frame2frame capabilities)",
    long_description=long_description,
    long_description_content_type="text/markdown",
    packages=find_packages(include=["frame2frame_tpu", "frame2frame_tpu.*",
                                    "frame2frame_tpu_torch",
                                    "frame2frame_tpu_torch.*"]),
    package_data={"frame2frame_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "numpy",
        "scipy",
        "pillow",
    ],
    extras_require={
        "test": ["pytest", "torch"],
    },
    entry_points={
        "console_scripts": [
            "f2f-blind-denoise=frame2frame_tpu.cli.blind_denoising:main",
            "f2f-tvl1flow=frame2frame_tpu.cli.tvl1flow:main",
            "f2f-torch-blind-denoise="
            "frame2frame_tpu_torch.cli.blind_denoising:main",
            "f2f-torch-tvl1flow=frame2frame_tpu_torch.cli.tvl1flow:main",
        ]
    },
)
