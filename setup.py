"""Packaging for torcheval_tpu (reference ``setup.py:44-80``: pure
setuptools package; the ``--nightly`` flag publishes a dated dev version,
reference ``setup.py:28-41,48-51``)."""

import argparse
import sys
from datetime import date
from pathlib import Path

from setuptools import find_packages, setup


def _version() -> str:
    ns = {}
    exec((Path(__file__).parent / "torcheval_tpu" / "version.py").read_text(), ns)
    return ns["__version__"]


def _parse_nightly():
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--nightly", action="store_true")
    args, rest = parser.parse_known_args(sys.argv[1:])
    sys.argv[1:] = rest
    return args.nightly


if __name__ == "__main__":
    nightly = _parse_nightly()
    name = "torcheval-tpu-nightly" if nightly else "torcheval-tpu"
    version = _version()
    if nightly:
        version += ".dev" + date.today().strftime("%Y%m%d")
    setup(
        name=name,
        version=version,
        description=(
            "A TPU-native (JAX/XLA/Pallas) library of performant model "
            "metrics with a distributed sync toolkit and model-eval tools"
        ),
        long_description=Path("README.md").read_text(),
        long_description_content_type="text/markdown",
        license="BSD-3-Clause",
        packages=find_packages(
            include=[
                "torcheval_tpu",
                "torcheval_tpu.*",
                "torcheval_tpu_torch",
                "torcheval_tpu_torch.*",
            ]
        ),
        # The PyTorch port builds its CUDA kernels with nvcc, and its host
        # edit distance with the system C++ compiler, from these sources at
        # first use, so they ship as files on disk; its static analyzer
        # reads its baseline beside it.
        package_data={
            "torcheval_tpu_torch.ops": ["csrc/*.cu", "csrc/*.cuh"],
            "torcheval_tpu_torch.native": ["*.cpp"],
            "torcheval_tpu_torch.analysis": ["tpulint.baseline"],
        },
        python_requires=">=3.10",
        install_requires=["jax", "numpy"],
        extras_require={
            "tools": ["flax"],
            "torch": ["torch"],
            "dev": ["pytest", "scikit-learn", "flax", "optax"],
        },
        zip_safe=False,
        classifiers=[
            "Development Status :: 3 - Alpha",
            "Intended Audience :: Developers",
            "Intended Audience :: Science/Research",
            "License :: OSI Approved :: BSD License",
            "Programming Language :: Python :: 3",
            "Topic :: Scientific/Engineering :: Artificial Intelligence",
        ],
    )
