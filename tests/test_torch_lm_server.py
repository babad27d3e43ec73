"""The port's ``LMServer`` and ``launch/serve.py --mode lm`` against the JAX
package's, on the CPU.

Given the reference server's parameters (carried across by ``interop``),
the port's server must emit the same token streams for the same requests,
including the reference's quirk that every slot's cache advances on every
step (a request that joins later sees the filler tokens of earlier steps).
Token ids are compared exactly: the smoke model is float32, and its top-2
logit margins on these inputs are far above the two packages' f32 rounding.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import qwen3_1_7b as jqwen  # noqa: E402
from repro.launch.serve import LMServer as JaxLMServer  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import qwen3_1_7b as tqwen  # noqa: E402
from repro_torch.launch.serve import LMServer  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


def _serve(srv, prompts, n):
    streams = []
    for p in prompts:
        slot = srv.add_request(p)
        streams.append((slot, list(srv.outputs[slot]), srv.generate(slot, n)))
    return streams


def test_lm_server_token_streams_equal_the_reference():
    import jax

    ref = JaxLMServer(jqwen.smoke_config(), max_batch=2, max_len=64, seed=0)
    cfg = tqwen.smoke_config()
    model = interop.transformer_params_from_numpy(
        jax.tree.map(np.asarray, ref.params), cfg, "cpu")
    srv = LMServer(cfg, max_batch=2, max_len=64, params=model, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=5), rng.integers(0, cfg.vocab_size, size=3)]
    got = _serve(srv, prompts, 6)
    want = _serve(ref, prompts, 6)
    assert got == want
    assert [s for s, _, _ in got] == [0, 1]
    # every slot's length advances on every step: 5 + 6 + 3 + 6 steps
    assert srv.cache["length"].tolist() == [5 + 6 + 3 + 6] * 2
    np.testing.assert_array_equal(srv.cache["length"].numpy(), np.asarray(ref.cache["length"]))


def test_lm_server_initialises_from_a_seed_on_the_cpu():
    cfg = tqwen.smoke_config()
    a = LMServer(cfg, max_batch=2, max_len=16, seed=7, device="cpu")
    b = LMServer(cfg, max_batch=2, max_len=16, seed=7, device="cpu")
    assert torch.equal(a.params.embed, b.params.embed)
    out = _serve(a, [np.asarray([3, 5, 7])], 4)
    assert out == _serve(b, [np.asarray([3, 5, 7])], 4)
    assert all(0 <= t < cfg.padded_vocab for t in out[0][2])


def test_serve_lm_mode_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "lm", "--device", "cpu",
         "--requests", "2", "--gen-tokens", "4"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(SRC)},
    )
    assert proc.returncode == 0, proc.stderr
    assert "tokens in" in proc.stdout and "request 1 slot 1" in proc.stdout
