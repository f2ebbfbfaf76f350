"""A module-scoped fixture for the port's tests: the JAX package's native
binding loads the port's build of native/graphtpu_io.cpp (under
build/graphtpu_torch/), so that no test of the port runs ``make`` in
native/. Without a C++ compiler both bindings are off; a
GRAPHTPU_NATIVE_LIB set by the caller is left as it is.

A test module takes it with ``from torch_native_env import
jax_native_on_port_build  # noqa: F401``."""

import os

import pytest

from graphtpu.ingest import native as jnative
from graphtpu_torch.ingest import native as tnative


@pytest.fixture(autouse=True, scope="module")
def jax_native_on_port_build():
    if "GRAPHTPU_NATIVE_LIB" in os.environ:
        yield
        return
    cxx = tnative._compiler()
    with pytest.MonkeyPatch.context() as mp:
        if cxx is None:
            mp.setattr(jnative, "_checked", True)
        else:
            mp.setenv("GRAPHTPU_NATIVE_LIB", str(tnative.build(cxx)))
            mp.setattr(jnative, "_checked", False)
        mp.setattr(jnative, "_lib", None)
        yield
