"""Build the native host runtime extension:

    python setup.py build_ext --inplace

cylon_tpu/native/runtime.py auto-detects the built module and falls back to
numpy when absent, so the package works either way.
"""
import numpy as np
from setuptools import Extension, setup

setup(
    name="cylon_tpu",
    version="0.1.0",
    packages=["cylon_tpu", "cylon_tpu.ops", "cylon_tpu.parallel",
              "cylon_tpu.native", "cylon_tpu.io",
              "cylon_tpu_torch", "cylon_tpu_torch.ops",
              "cylon_tpu_torch.parallel", "cylon_tpu_torch.analysis",
              "cylon_tpu_torch.io", "cylon_tpu_torch.native",
              "cylon_tpu_torch.observe", "cylon_tpu_torch.plan",
              "cylon_tpu_torch.serve", "cylon_tpu_torch.spill",
              "cylon_tpu_torch.tpch", "cylon_tpu_torch.pycylon",
              "cylon_tpu_torch.pycylon.common", "cylon_tpu_torch.pycylon.ctx",
              "cylon_tpu_torch.pycylon.data", "cylon_tpu_torch.pycylon.io",
              "cylon_tpu_torch.pycylon.net", "cylon_tpu_torch.pycylon.util",
              "cylon_tpu_torch.pycylon.util.data",
              "pycylon", "pycylon.common", "pycylon.ctx", "pycylon.data",
              "pycylon.io", "pycylon.net", "pycylon.util",
              "pycylon.util.data"],
    # the PyTorch port's CUDA source, built with nvcc at first use, and
    # the executable the Java binding names with -Dcylon.gateway.python
    package_data={"cylon_tpu_torch": ["csrc/*.cu",
                                      "pycylon/java_launcher.py"]},
    ext_modules=[
        Extension(
            "cylon_tpu.native._cylon_native",
            sources=["cylon_tpu/native/_cylon_native.cpp"],
            include_dirs=[np.get_include()],
            extra_compile_args=["-O3", "-std=c++17", "-Wall"],
            language="c++",
        )
    ],
)
