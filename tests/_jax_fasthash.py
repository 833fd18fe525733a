"""Shared fixture of the port's tests that hold its hashed featurizer
against JAX's native one. Import it by name into a test module:

    from tests._jax_fasthash import jax_native_from_port_build  # noqa: F401
"""

import pytest

from ragfin_tpu.models import fasthash as j_fasthash
from ragfin_tpu_torch.models import fasthash as t_fasthash


@pytest.fixture(scope="module", autouse=True)
def jax_native_from_port_build():
    """JAX's native featurizer loads the port's build of the same source.
    JAX's loader builds ``native/build/libfasthash.so`` in place with
    ``make -C native``: test workers that build and load it at once can find
    the file half written, and JAX then takes its Python path, whose IDF
    table (and so its ``state_dict``) comes in another order than the native
    path's. The port's build is renamed into place whole, so JAX's own
    loader is pointed at that file; without it both packages take their
    Python paths."""
    native = t_fasthash.available()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_fasthash, "_LIB_PATH", t_fasthash.LIB_PATH)
        mp.setattr(j_fasthash, "_lib", None)
        mp.setattr(j_fasthash, "_load_attempted", not native)
        yield
