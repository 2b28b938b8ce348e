"""The port's ``training/compression.py`` against the JAX package's, on the
CPU, bit for bit:

* ``_quantize`` / ``_dequantize`` on float32 and bfloat16 tensors, all
  zeros (the 1e-12 floor), exact halves (``round`` to even) and the +-127
  clip;
* ``compress_with_feedback`` over 10 steps of a tree (float32 and bfloat16
  leaves) with its error state carried, and ``decompress``: every int8
  payload, scale and error equal to JAX's;
* ``compressed_psum`` at world sizes 1 and 2 (gloo ranks,
  ``tests/torch_ranks.py``; world size 1 in this process) over 3 steps,
  each rank its own gradients, against JAX's under ``shard_map`` on 1 and
  2 devices (a subprocess with 2 fake host devices): each rank's means
  and new errors equal to JAX's for its device.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torch_ranks as R
from repro_torch.training import compression as C

STEPS, PSUM_STEPS = 10, 3
SHAPES = {"a": (5, 7), "b": (33,), "c": (2, 3, 4)}


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.training import compression as jax_c
    return dict(jax=jax, jnp=jnp, c=jax_c)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _grads(seed, bf16=False):
    rng = np.random.default_rng(seed)
    g = {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 3)).astype(np.float32)
         for k, s in SHAPES.items()}
    if bf16:   # one leaf in bfloat16, as a bf16 model's gradient
        g["c"] = torch.from_numpy(g["c"]).bfloat16().float().numpy()
    return g


@pytest.mark.parametrize("case", ["random", "zeros", "halves", "bf16"])
def test_quantize_matches_jax(J, case):
    jnp = J["jnp"]
    rng = np.random.default_rng(1)
    x = rng.standard_normal(257).astype(np.float32) * 3
    if case == "zeros":
        x[:] = 0
    elif case == "halves":   # x / scale lands on k + 0.5
        x = (np.arange(-127, 128, dtype=np.float32) + 0.5) / 127.5 * 2.0
        x[0] = -2.0
    t = torch.from_numpy(x)
    jx = jnp.asarray(x)
    if case == "bf16":
        t, jx = t.bfloat16(), jx.astype(jnp.bfloat16)
    q, s = C._quantize(t)
    jq, js = J["c"]._quantize(jx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.ndim == 0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    np.testing.assert_array_equal(C._dequantize(q, s).numpy(), np.asarray(J["c"]._dequantize(jq, js)))
    if case == "halves":
        assert int(q.abs().max()) == 127


def test_compress_with_feedback_matches_jax_over_steps(J):
    jnp = J["jnp"]
    errors = C.init_error_feedback({k: torch.zeros(s) for k, s in SHAPES.items()})
    jerrors = J["c"].init_error_feedback({k: jnp.zeros(s) for k, s in SHAPES.items()})
    assert all(e.dtype == torch.float32 and not e.any() for e in errors.values())
    for step in range(STEPS):
        g = _grads(step, bf16=step % 2 == 1)
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        if step % 2:
            tg["c"], jg["c"] = tg["c"].bfloat16(), jg["c"].astype(jnp.bfloat16)
        qs, ss, errors = C.compress_with_feedback(tg, errors)
        jqs, jss, jerrors = J["c"].compress_with_feedback(jg, jerrors)
        for k in SHAPES:
            np.testing.assert_array_equal(qs[k].numpy(), np.asarray(jqs[k]))
            assert ss[k].numpy().tobytes() == np.asarray(jss[k]).tobytes()
            assert errors[k].numpy().tobytes() == np.asarray(jerrors[k]).tobytes()
        dec, jdec = C.decompress(qs, ss), J["c"].decompress(jqs, jss)
        for k in SHAPES:
            assert dec[k].numpy().tobytes() == np.asarray(jdec[k]).tobytes()


JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.training.compression import compressed_psum, init_error_feedback

    z = np.load(sys.argv[1])
    out = {}
    for n in (1, 2):
        mesh = jax.make_mesh((n,), ("pod",))
        fn = jax.jit(jax.shard_map(lambda g, e: compressed_psum(g, e, "pod"), mesh=mesh,
                                   in_specs=(P("pod"), P("pod")),
                                   out_specs=(P("pod"), P("pod")), check_vma=False))
        errors = None
        for s in range(int(sys.argv[3])):
            g = {k: jnp.asarray(z[k][s, :n]) for k in z.files}
            errors = init_error_feedback(g) if errors is None else errors
            means, errors = fn(g, errors)
            for k in z.files:
                out[f"{n}/{s}/mean/{k}"] = np.asarray(means[k])
                out[f"{n}/{s}/error/{k}"] = np.asarray(errors[k])
    np.savez(sys.argv[2], **out)
    print("JAX_PSUM_OK")
""")


@pytest.fixture(scope="module")
def psum_runs(tmp_path_factory):
    """Each step's gradients for 2 ranks, JAX's results (subprocess) and the
    port's ranks' (world 2 spawned, world 1 here), started together."""
    pytest.importorskip("jax")
    out = tmp_path_factory.mktemp("psum")
    rng = np.random.default_rng(7)
    z = {k: (rng.standard_normal((PSUM_STEPS, 2, *s))
             * np.array([1.0, 40.0]).reshape(1, 2, *([1] * len(s)))).astype(np.float32)
         for k, s in SHAPES.items()}   # rank 1's scale is larger: the MAX matters
    np.savez(out / "grads.npz", **z)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in ("src", os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(out / "grads.npz"),
                             str(out / "jax.npz"), str(PSUM_STEPS)], env=env, cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = R.Ranks(R.compression_rank, 2, out, str(out / "grads.npz"), PSUM_STEPS, str(out))
        with R.process_group(out):
            R.compression_rank(0, 1, str(out / "grads.npz"), PSUM_STEPS, str(out))
        ranks.join()
        stdout, stderr = proc.communicate(timeout=120)
    finally:
        proc.kill()
        proc.wait()
    assert "JAX_PSUM_OK" in stdout, stdout + stderr
    port = {n: [torch.load(out / f"compression-{n}-{r}.pt") for r in range(n)] for n in (1, 2)}
    return dict(np.load(out / "jax.npz")), port


@pytest.mark.parametrize("world", [1, 2])
def test_compressed_psum_matches_jax(psum_runs, world):
    jx, port = psum_runs
    for rank, steps in enumerate(port[world]):
        assert len(steps) == PSUM_STEPS
        for s, (means, errors) in enumerate(steps):
            for k in SHAPES:
                want_m = jx[f"{world}/{s}/mean/{k}"][rank]
                want_e = jx[f"{world}/{s}/error/{k}"][rank]
                assert means[k].dtype == torch.float32
                assert means[k].numpy().tobytes() == want_m.tobytes(), (world, rank, s, k)
                assert errors[k].numpy().tobytes() == want_e.tobytes(), (world, rank, s, k)
    if world == 2:   # the means are the group's: equal on both ranks
        for (m0, _), (m1, _) in zip(port[2][0], port[2][1]):
            assert all(torch.equal(m0[k], m1[k]) for k in SHAPES)
