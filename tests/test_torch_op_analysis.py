"""The port's op census (``repro_torch.launch.op_analysis``) on the CPU: the
counterpart of the reference's ``launch/hlo_analysis.py``.

Exact FLOPs of a matmul chain; a Python loop of 10 matmuls counted 10
times (the reference's trip-count point, by construction here); views not
billed and elementwise ops billed (eager PyTorch fuses nothing); a
kernel's reported work, deferred to the census's close; a copy between
devices kept apart from HBM bytes; and the collective helpers of
``core.distributed`` at p = 2 and p = 4 in 4 gloo ranks (the ranks of
``tests/test_torch_audit.py``, ``_torch_dist.obs_ranks``), each with the
reference's ring factor, its ``c10d`` op not billed as HBM.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_dist import obs_runs  # noqa: E402
from repro.launch.hlo_analysis import _collective_link_bytes  # noqa: E402
from repro_torch.launch import op_analysis  # noqa: E402
from repro_torch.launch.op_analysis import analyze  # noqa: E402

F32 = 4


def _rand(*shape):
    g = torch.Generator().manual_seed(0)
    return torch.randn(*shape, generator=g)


def test_matmul_chain_flops_are_exact():
    a, b, c = _rand(8, 16), _rand(16, 32), _rand(32, 4)
    out, got = analyze(lambda: (a @ b) @ c)
    assert torch.allclose(out, (a @ b) @ c)
    assert got["flops"] == 2 * 8 * 16 * 32 + 2 * 8 * 32 * 4
    x = _rand(3, 8, 16)  # batched matmul and einsum reach bmm
    _, got = analyze(lambda: torch.einsum("brk,kc->brc", x, b) + torch.matmul(x, b))
    assert got["flops"] == 2 * (2 * 3 * 8 * 16 * 32)


def test_python_loop_of_matmuls_counts_every_iteration():
    """The reference bills a scanned body by its trip count; eager PyTorch
    dispatches every iteration, so the census counts 10 of them as 10."""
    T, n = 10, 32
    x, w = _rand(n, n), _rand(n, n)

    def loop(c):
        for _ in range(T):
            c = torch.tanh(c @ w)
        return c

    _, once = analyze(lambda: torch.tanh(x @ w))
    _, got = analyze(loop, x)
    assert got["flops"] == T * 2 * n ** 3 == T * once["flops"]
    assert got["hbm_bytes"] == T * once["hbm_bytes"]
    assert got["n_ops"] == T * once["n_ops"] == 2 * T


def test_views_are_free_and_elementwise_ops_are_billed():
    x = _rand(16, 8)
    nb = 16 * 8 * F32
    _, views = analyze(lambda: x.view(8, 16).t().transpose(0, 1)[2:].unsqueeze(0).detach())
    assert views["hbm_bytes"] == 0 and views["flops"] == 0 and views["n_ops"] >= 5
    _, add = analyze(lambda: x + x)
    assert add["hbm_bytes"] == 3 * nb  # two reads, one write: nothing is fused
    _, chain = analyze(lambda: torch.relu(x * 2.0) + 1.0)
    assert chain["hbm_bytes"] == 3 * 2 * nb
    _, inplace = analyze(lambda: x.clone().mul_(2.0))
    assert inplace["hbm_bytes"] == 2 * nb + 2 * nb  # clone; read and write in place
    _, copy = analyze(lambda: torch.empty_like(x).copy_(x))
    assert copy["hbm_bytes"] == 2 * nb  # copy_ does not read its destination
    idx = torch.tensor([0, 3, 5])
    _, gather = analyze(lambda: x[idx])
    assert gather["hbm_bytes"] == 2 * 3 * 8 * F32 + 3 * 8  # the rows read, not all of x


def test_copy_between_devices_is_host_copy_not_hbm():
    """A transfer between host and another device (here ``meta``: the
    gloo staging of ``_to_wire`` moves card tensors to the host the same
    way) goes to ``host_copy_bytes``, never to ``hbm_bytes``."""
    x = _rand(32, 16)
    _, got = analyze(lambda: x.to("meta"))
    assert got["host_copy_bytes"] == 32 * 16 * F32
    assert got["hbm_bytes"] == 0
    _, same = analyze(lambda: x.to("cpu", copy=True))
    assert same["host_copy_bytes"] == 0 and same["hbm_bytes"] == 2 * 32 * 16 * F32


def test_kernel_reports_are_deferred_to_the_census_close():
    assert op_analysis.CENSUS is None  # no census: the hooks' one check fails
    reads = []

    def launch():
        assert op_analysis.CENSUS is not None
        before = len(reads)
        op_analysis.report_kernel("k", "lib", 10.0, lambda: reads.append(1) or 6.0)
        op_analysis.report_kernel("k", "lib", lambda: 5.0, 2.0)
        assert len(reads) == before  # nothing read in the hot path
        return 1

    out, got = analyze(launch)
    assert out == 1 and reads == [1]
    assert got["kernels"] == {"k": {"launches": 2, "flops": 15.0, "bytes": 8.0}}
    assert got["flops"] == 15.0 and got["hbm_bytes"] == 8.0
    assert got["libraries"] == ["lib"]
    assert op_analysis.CENSUS is None
    _, outer = analyze(lambda: analyze(launch))  # an outer census counts the inner's
    assert outer["kernels"]["k"]["launches"] == 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return [r["census"] for r in obs_runs(tmp_path_factory.mktemp("census"))]


KINDS = {  # helper: (reference HLO op, payload rows of the (16, 8) operand at p)
    "ppermute": ("collective-permute", lambda p: 16),
    "psum": ("all-reduce", lambda p: 16),
    "pmax": ("all-reduce", lambda p: 16),
    "psum_scatter": ("reduce-scatter", lambda p: 16 // p),
    "all_gather": ("all-gather", lambda p: 16 * p),
}


class _Instr:
    """A collective as the reference's HLO analyzer sees it."""

    def __init__(self, op, shapes, p):
        self.op, self.shapes = op, shapes
        self.line = f"replica_groups=[{4 // p},{p}]<=[4]"


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("helper", sorted(KINDS))
def test_collective_link_bytes_use_the_reference_factors(ranks, helper, p):
    kind, rows = KINDS[helper]
    payload = rows(p) * 8 * F32
    _, _, want_link = _collective_link_bytes(_Instr(kind, [("f32", [rows(p), 8])], p))
    for got in (r[(helper, p)] for r in ranks):
        c = got["collectives"][kind]
        assert c["count"] == 1
        assert c["payload_bytes"] == payload
        assert c["link_bytes"] == pytest.approx(want_link, rel=1e-12)
        assert got["link_bytes"] == c["link_bytes"]
        assert got["host_copy_bytes"] == 0  # CPU tensors travel as they are
        others = [k for k, v in got["collectives"].items() if v["count"] and k != kind]
        assert not others


def test_collective_payloads_are_not_billed_as_hbm(ranks):
    """The ``c10d`` ops are skipped by the dispatch census: a collective's
    wire bytes are link bytes only. What is billed is the helpers' own
    device work (the all-reduce's copy of its operand, the receive
    buffer's zeros, gloo's copy of its reduce-scatter result into place),
    never the payload a second time."""
    nb = 16 * 8 * F32
    for r in ranks:
        for p in (2, 4):
            assert r[("psum", p)]["hbm_bytes"] == 2 * nb  # the clone it reduces in place
            assert r[("ppermute", p)]["hbm_bytes"] == nb  # zeros_like of the receive buffer
            assert r[("all_gather", p)]["hbm_bytes"] == 0
            assert r[("psum_scatter", p)]["hbm_bytes"] == 2 * nb // p
