"""The closed loop in the port against the JAX package on the CPU: a model's
HLO fixture extracted and mapped onto ``physical_hierarchy()`` (16:16,
k = 256), the logical mesh graph and the mesh's device order, and
``tpu_v5e_hierarchy``.

whisper-tiny's extracted graph, mapped with ``preset="fast"`` and the
refinement backend pinned, gives the reference's ``pe_of`` bit for bit and
J below the default placement's (the reference's closed-loop contract).
xlstm-125m's graph is mapped on the card only (``chip_smoke.py``), to keep
this suite's time."""
import gzip
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from repro.core.api import SharedMapConfig as JConfig
from repro.core.api import shared_map_direct as jax_shared_map
from repro.core.hierarchy import tpu_v5e_hierarchy as jax_tpu_v5e_hierarchy
from repro.core.mapping import evaluate_J as jax_evaluate_J
from repro.launch import comm_graph as JCG
from repro.launch import mesh as JM
from repro_torch.core.api import SharedMapConfig, shared_map_direct
from repro_torch.core.hierarchy import tpu_v5e_hierarchy
from repro_torch.core.mapping import evaluate_J
from repro_torch.launch import comm_graph as TCG
from repro_torch.launch import mesh as TM

HLO_DIR = Path(__file__).resolve().parent / "data" / "hlo"


@pytest.fixture(scope="module")
def whisper():
    with gzip.open(HLO_DIR / "whisper_tiny_train.hlo.txt.gz") as f:
        text = f.read().decode()
    side = json.loads((HLO_DIR / "whisper_tiny_train.json").read_text())
    hints, min_tasks = side["trip_hints"], side["min_tasks"]
    return (JCG.extract_comm_graph(text, hints, min_tasks=min_tasks),
            TCG.extract_comm_graph(text, hints, min_tasks=min_tasks), side)


def test_whisper_mapping_matches_reference(whisper):
    """fast, xla pinned (the sidecar's config): the reference's pe_of, the
    sidecar's digest and J, and J below the default placement's."""
    jtg, ttg, side = whisper
    h, jh = TM.physical_hierarchy(), JM.physical_hierarchy()
    want = jax_shared_map(jtg, jh, JConfig(preset="fast", backend="xla"))
    got = shared_map_direct(ttg, h, SharedMapConfig(preset="fast", backend="xla"),
                            device="cpu")
    assert got.pe_of.dtype == np.int32
    assert np.array_equal(got.pe_of, want.pe_of)
    assert got.J == pytest.approx(want.J, rel=1e-6)
    assert want.J == side["J_xla_fast"]   # the sidecar is the live reference's
    digest = hashlib.blake2b(np.ascontiguousarray(got.pe_of[: ttg.n]).tobytes(),
                             digest_size=16).hexdigest()
    assert digest == side["pe_of_blake2b"]
    g = ttg.to_graph(device="cpu")
    j_default = evaluate_J(g, h, TCG.default_placement(ttg.n, h.k), device="cpu")
    assert j_default == pytest.approx(side["J_default"], rel=1e-6)
    assert jax_evaluate_J(jtg.to_graph(), jh, JCG.default_placement(jtg.n, jh.k)) \
        == side["J_default"]
    assert got.J < j_default


@pytest.mark.parametrize("multi_pod", [False, True])
def test_logical_comm_graph_and_hierarchies(multi_pod):
    got, want = TM.logical_comm_graph(multi_pod), JM.logical_comm_graph(multi_pod)
    assert got.fingerprint() == want.fingerprint()
    assert got.meta == want.meta and got.n == (512 if multi_pod else 256)
    for mine, ref in ((TM.physical_hierarchy(multi_pod), JM.physical_hierarchy(multi_pod)),
                      (tpu_v5e_hierarchy(multi_pod), jax_tpu_v5e_hierarchy(multi_pod))):
        assert (mine.a, mine.d, mine.k) == (ref.a, ref.d, ref.k)


def test_sharedmap_device_order_matches_reference():
    perm = TM.sharedmap_device_order(False)
    want = JM.sharedmap_device_order(False)
    assert perm.dtype == want.dtype and np.array_equal(perm, want)
    assert sorted(perm.tolist()) == list(range(256))
    h = TM.physical_hierarchy(False)
    g = TM.logical_comm_graph(False).to_graph(device="cpu")
    j_default = evaluate_J(g, h, np.arange(256, dtype=np.int32), device="cpu")
    assert evaluate_J(g, h, perm, device="cpu") <= j_default


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_initial_partition_with_fewer_vertices_than_blocks(n):
    """A leaf subgraph of an extracted graph may hold fewer tasks than its
    k = 16 blocks: the seeds then share vertices, and the last seed written
    wins, as in the reference (the card takes the same one)."""
    import jax.numpy as jnp
    import torch

    from repro.core import graph as JG
    from repro.core import initial as JI
    from repro_torch.core import graph as TG
    from repro_torch.core import initial as TI
    jg = JG.from_edges(n, np.arange(n - 1), np.arange(1, n), N=8, M=8)
    tg = TG.graph_from_numpy({f: np.asarray(getattr(jg, f)) for f in TG.Graph._fields},
                             device="cpu")
    for salt in (0, 5, 12):
        want = JI.initial_partition(jg, 16, jnp.float32(100.0), salt=salt, backend="xla")
        got = TI.initial_partition(tg, 16, torch.tensor(100.0), salt=salt, backend="xla")
        assert np.array_equal(got.numpy(), np.asarray(want))
