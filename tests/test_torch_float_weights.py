"""Float-weighted graphs: the port against the JAX package on the CPU.

rgg 2000 and grid 32x32 with every vertex weight and every undirected edge
weight multiplied by a seeded uniform float in [0.5, 1.5)
(``graph.float_weights``), mapped by ``shared_map`` on 4:2 with the
``ell`` and the ``xla`` refinement pinned in both packages. Sums of such
weights round, so equal ``pe_of`` needs the same order of every sum as
well as the same algorithm. The card runs the same instances twice and
against the CPU (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest

from repro.core import graph as JG
from repro.core.api import SharedMapConfig as JConfig
from repro.core.api import shared_map as jax_shared_map
from repro.core.hierarchy import Hierarchy as JH
from repro_torch.core import graph as TG
from repro_torch.core.api import SharedMapConfig, shared_map
from repro_torch.core.hierarchy import Hierarchy

INSTANCES = {"grid32": lambda: TG.gen_grid(32, device="cpu"),
             "rgg2000": lambda: TG.gen_rgg(2000, seed=3, device="cpu")}
A, D = (4, 2), (1.0, 10.0)


@pytest.mark.parametrize("backend", ["ell", "xla"])
@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_float_weights_equal_the_reference(name, backend):
    tg = TG.float_weights(INSTANCES[name](), seed=7)
    assert not np.array_equal(tg.vwgt.numpy(), np.round(tg.vwgt.numpy()))
    jg = JG.Graph(**{f: np.asarray(getattr(tg, f).numpy()) for f in TG.Graph._fields})
    jr = jax_shared_map(jg, JH(A, D), JConfig(backend=backend))
    tr = shared_map(tg, Hierarchy(A, D), SharedMapConfig(backend=backend), device="cpu")
    assert np.array_equal(tr.pe_of, jr.pe_of)
    assert tr.J == pytest.approx(jr.J, rel=1e-6)
