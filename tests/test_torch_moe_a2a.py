"""Expert parallelism in the port (``repro_torch.models.moe``'s
``_local_dispatch`` and ``moe_apply_a2a``) against the JAX package's, on the
CPU, in float32:

* ``_local_dispatch``'s buffer, slot and kept equal to JAX's, with and
  without ``valid``, with rows past the capacity;
* ``moe_apply_a2a`` on ``reduced(deepseek-moe-16b)``'s MoE (8 routed
  experts of 32, top-2, 1 shared; parameters and x from a numpy seed, x
  sharing a direction so that the load is uneven), at its own capacity
  factor (1.5: pairs drop) and at 8.0, on meshes (1, 1), (1, 2) and (2, 2)
  of ("data", "model"): every rank's routing, its ``(slot, kept)`` at both
  dispatches, equal to JAX's to the integer (checked first: a pair routed
  otherwise changes y without raising); y within 1e-5 and aux within 1e-6;
  every gradient leaf of ``sum(y**2) + 0.01 * aux``, x's included, within
  1e-5 of ``jax.grad``'s, relative to the leaf's largest magnitude;
  ``count_drops`` summed over the ranks equal to the pairs JAX's dispatches
  drop; at capacity 8.0, y within 2e-4 of ``moe_apply`` (JAX's own test's
  tolerance, ``tests/test_moe_a2a.py``); a plain x or plain parameters on a
  mesh of more than one rank raising;
* one call's collectives, read by ``roofline.counts``, against their
  formula at world sizes 1 and 2;
* at world size 1, ``transformer.loss_fn`` under
  ``activation_sharding(mesh, lm_rules(mesh), moe_a2a=True)`` (remat on and
  off) against JAX's ``loss_fn`` under the same context on a (1, 1) mesh:
  the loss, ``moe_aux`` and every gradient leaf; under remat each layer's
  recomputed routing equal to its first pass's, through the all-to-all.

JAX's multi-device side runs once for the file in a subprocess with 4 fake
host devices (``--xla_force_host_platform_device_count``, which must be set
before JAX starts); the port's ranks are gloo processes
(``tests/torch_ranks.py``), world size 1 in this process.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torch_ranks as R
from repro_torch.configs import get_config, reduced
from repro_torch.core.treepath import tree_leaves
from repro_torch.distributed import context as shctx
from repro_torch.models import moe, transformer as tfm

torch.set_num_threads(2)

MESHES = ((1, 1), (1, 2), (2, 2))
CAPACITIES = (1.5, 8.0)     # reduced(deepseek-moe-16b)'s own, and ample
Y_ATOL, AUX_ATOL, GRAD_REL = 1e-5, 1e-6, 1e-5
GATHER_TOL = 2e-4           # tests/test_moe_a2a.py's a2a == moe_apply
B, S = 4, 32

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config, reduced
    from repro.distributed import context as ctx
    from repro.models import moe as moe_lib, transformer as tfm

    z = np.load(sys.argv[1])
    p = {k: z[k] for k in ("router", "w_gate", "w_up", "w_down")}
    p["shared"] = {k: z["shared/" + k] for k in ("w_gate", "w_up", "w_down")}
    x = z["x"]
    base = reduced(get_config("deepseek-moe-16b"))
    records, out = [], {}
    orig = moe_lib._local_dispatch

    def recorded(xx, ids, nb, cap, valid=None):
        buf, slot, kept = orig(xx, ids, nb, cap, valid)
        tag = sum(r is None for r in records)     # the call's place in the trace
        v = jnp.ones_like(kept) if valid is None else valid
        jax.debug.callback(
            lambda di, mi, s, k, v: records.append((int(di), int(mi), tag, np.asarray(s),
                                                    np.asarray(k), np.asarray(v))),
            jax.lax.axis_index("data"), jax.lax.axis_index("model"), slot, kept, v)
        records.append(None)
        return buf, slot, kept

    moe_lib._local_dispatch = recorded
    for shape in ((1, 1), (1, 2), (2, 2)) if sys.argv[3] == "a2a" else ():
        mesh = jax.make_mesh(shape, ("data", "model"))
        xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data", "model", None)))
        for cf in (1.5, 8.0):
            cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe,
                                                                    capacity_factor=cf))
            key = f"{shape[0]}x{shape[1]}/{cf}/"

            def loss(pp, xx):
                yy, a = moe_lib.moe_apply_a2a(pp, xx, cfg, mesh)
                return jnp.sum(yy ** 2) + 0.01 * a, (yy, a)

            records.clear()
            (_, (y, aux)), (g, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(p, xs)
            jax.block_until_ready(gx)
            jax.effects_barrier()
            for di, mi, tag, s, k, v in [r for r in records if r is not None]:
                out[f"{key}rec/{di}/{mi}/{tag}/slot"] = s
                out[f"{key}rec/{di}/{mi}/{tag}/kept"] = k
                out[f"{key}rec/{di}/{mi}/{tag}/valid"] = v
            out[key + "y"], out[key + "aux"], out[key + "grad/x"] = y, aux, gx
            for k in ("router", "w_gate", "w_up", "w_down"):
                out[key + "grad/" + k] = g[k]
            for k in ("w_gate", "w_up", "w_down"):
                out[key + "grad/shared/" + k] = g["shared"][k]
    moe_lib._local_dispatch = orig

    # ("lm") the MoE LM's loss_fn under the context on a (1, 1) mesh; Auto axes:
    # jax 0.9's make_mesh defaults to Explicit ones, which
    # with_sharding_constraint (the context's constrain) refuses
    lcfg = dataclasses.replace(base, attn_impl="chunked", remat=False)
    lparams = tfm.init_lm(jax.random.PRNGKey(0), lcfg)
    toks = np.random.default_rng(3).integers(0, lcfg.vocab_size, (2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    auto = jax.sharding.AxisType.Auto
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(auto, auto))

    def lm_loss(pp, b):
        with ctx.activation_sharding(mesh, ctx.lm_rules(mesh), moe_a2a=True):
            return tfm.loss_fn(pp, b, lcfg)

    if sys.argv[3] == "lm":
        (l, m), g = jax.jit(jax.value_and_grad(lm_loss, has_aux=True))(lparams, batch)
        for name, tree in (("param", lparams), ("grad", g)):
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
                out[f"lm/{name}/" + jax.tree_util.keystr(path, simple=True, separator="/")] = v
        out.update({"lm/loss": l, "lm/ce": m["ce"], "lm/aux": m["moe_aux"],
                    "lm/tokens": batch["tokens"], "lm/labels": batch["labels"]})
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
    print("JAX_A2A_OK")
""")


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import moe as jax_moe
    return dict(jnp=jnp, moe=jax_moe)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The MoE parameters and x of every a2a case, from numpy seed 0."""
    cfg = reduced(get_config("deepseek-moe-16b"))
    d, e, de = cfg.d_model, cfg.moe.n_routed, cfg.moe.d_expert
    rng = np.random.default_rng(0)

    def normal(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    z = {"router": normal((d, e), d), "w_gate": normal((e, d, de), d),
         "w_up": normal((e, d, de), d), "w_down": normal((e, de, d), de),
         "shared/w_gate": normal((d, de), d), "shared/w_up": normal((d, de), d),
         "shared/w_down": normal((de, d), de)}
    # a direction every token shares, as a residual stream's do: uneven load
    z["x"] = (rng.standard_normal((B, S, d))
              + 1.5 * rng.standard_normal((1, 1, d))).astype(np.float32)
    path = tmp_path_factory.mktemp("a2a") / "inputs.npz"
    np.savez(path, **z)
    return path


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """JAX's results (the subprocess) and the port's ranks' for every mesh
    and capacity, all started together: world 2 and 4 spawned, world 1 in
    this process."""
    pytest.importorskip("jax")
    out = tmp_path_factory.mktemp("a2a-out")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in ("src", os.environ.get("PYTHONPATH")) if p))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dirs = {shape: out / f"{shape[0]}x{shape[1]}" for shape in MESHES}
    for d in dirs.values():
        d.mkdir()
    # the a2a cases and the LM: two JAX processes, beside the port's ranks
    procs = [subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(inputs),
                               str(out / f"jax-{part}.npz"), part],
                              env=env, cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for part in ("a2a", "lm")]
    try:
        ranks = [R.Ranks(R.a2a_rank, shape[0] * shape[1], out, str(inputs), shape,
                         CAPACITIES, str(dirs[shape])) for shape in MESHES[1:]]
        with R.process_group(out):
            R.a2a_rank(0, 1, str(inputs), MESHES[0], CAPACITIES, str(dirs[MESHES[0]]))
        for r in ranks:
            r.join()
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=300)
            assert "JAX_A2A_OK" in stdout, stdout + stderr
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    port = {shape: [torch.load(dirs[shape] / f"a2a-{r}.pt", weights_only=False)
                    for r in range(shape[0] * shape[1])] for shape in MESHES}
    jx = {**np.load(out / "jax-a2a.npz"), **np.load(out / "jax-lm.npz")}
    return jx, port


def _key(shape, cf):
    return f"{shape[0]}x{shape[1]}/{cf}/"


# ---------------------------------------------------------------------------
# _local_dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("cap", [3, 8, 64])
def test_local_dispatch_matches_jax(J, with_valid, cap):
    jnp = J["jnp"]
    rng = np.random.default_rng(cap + 10 * with_valid)
    x = rng.standard_normal((40, 6)).astype(np.float32)
    ids = rng.integers(0, 4, 40).astype(np.int32)
    ids[:12] = 2                                        # one bucket overflows at cap 3, 8
    valid = rng.random(40) < 0.7 if with_valid else None
    jbuf, jslot, jkept = J["moe"]._local_dispatch(
        jnp.asarray(x), jnp.asarray(ids), 4, cap,
        None if valid is None else jnp.asarray(valid))
    buf, slot, kept = moe._local_dispatch(
        torch.from_numpy(x), torch.from_numpy(ids).long(), 4, cap,
        None if valid is None else torch.from_numpy(valid))
    assert buf.shape == (4, cap, 6) and buf.is_contiguous()
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jkept))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    if cap < 12:
        assert not bool(kept.all())                     # rows past the capacity dropped


def test_local_dispatch_gradient_reads_kept_rows():
    """The buffer's gradient reaches a kept row from its slot and a row not
    kept not at all."""
    x = torch.randn(10, 3, requires_grad=True)
    ids = torch.tensor([0, 0, 0, 1, 1, 0, 1, 0, 1, 1])
    buf, slot, kept = moe._local_dispatch(x, ids, 2, 3)
    cot = torch.randn_like(buf)
    (buf * cot).sum().backward()
    want = torch.where(kept[:, None], cot[ids, torch.clamp_max(slot, 2)], 0.0)
    torch.testing.assert_close(x.grad, want, rtol=0, atol=0)


# (tokens a rank, top_k, capacity factor, ranks of "model", routed experts),
# and JAX's cap = max(8, ceil(T k cf / M / 8) 8), cap2 = max(8, ceil(M cap
# 1.1 / E_local / 8) 8) worked by hand (src/repro/models/moe.py:194-215)
CAPACITY_CASES = [((16384, 6, 1.25, 1, 64), (122880, 2112)),   # deepseek-moe-16b 8 x 2048
                  ((64, 2, 1.5, 2, 8), (96, 56)),
                  ((2, 2, 1.0, 4, 8), (8, 24)),                # cap at its floor of 8
                  ((2, 2, 1.0, 1, 64), (8, 8)),                # both at their floor
                  ((128, 2, 8.0, 1, 8), (2048, 288))]


@pytest.mark.parametrize("case,want", CAPACITY_CASES)
def test_a2a_capacity_is_jaxs(case, want):
    """``a2a_capacity``, which ``moe_apply_a2a`` sizes its buffers by."""
    t, k, cf, m, n_routed = case
    spec = dataclasses.replace(get_config("deepseek-moe-16b").moe, top_k=k,
                               capacity_factor=cf, n_routed=n_routed)
    assert moe.a2a_capacity(t, spec, m) == want


# ---------------------------------------------------------------------------
# moe_apply_a2a against JAX, at every mesh and capacity
# ---------------------------------------------------------------------------

CASES = [(shape, cf) for shape in MESHES for cf in CAPACITIES]
IDS = [f"{s[0]}x{s[1]}-cf{cf}" for s, cf in CASES]


@pytest.mark.parametrize("shape,cf", CASES, ids=IDS)
def test_a2a_routing_matches_jax(runs, shape, cf):
    """Every rank's (slot, kept) at both dispatches (and the meta buffer's)
    equal to JAX's for the device at its mesh coordinate; ``count_drops``
    summed over the ranks equal to JAX's drops: the pairs not kept at the
    first dispatch and the received rows that held a pair (valid) but were
    not kept at the second."""
    jx, port = runs
    key = _key(shape, cf)
    dropped = routed = jax_dropped = 0
    for res in port[shape]:
        di, mi = res["coord"]
        rec = f"{key}rec/{di}/{mi}/"
        records = res[cf]["records"]
        assert len(records) == 3
        for tag, (slot, kept) in enumerate(records):
            np.testing.assert_array_equal(slot.numpy(), jx[f"{rec}{tag}/slot"])
            np.testing.assert_array_equal(kept.numpy(), jx[f"{rec}{tag}/kept"])
        dropped += res[cf]["dropped"]
        routed += res[cf]["routed"]
        jax_dropped += int((~jx[f"{rec}0/kept"]).sum())
        jax_dropped += int((jx[f"{rec}2/valid"] & ~jx[f"{rec}2/kept"]).sum())
    assert routed == B * S * reduced(get_config("deepseek-moe-16b")).moe.top_k
    assert dropped == jax_dropped
    if cf == 1.5:
        assert dropped > 0, "the case meant to drop pairs dropped none"


@pytest.mark.parametrize("shape,cf", CASES, ids=IDS)
def test_a2a_values_match_jax(runs, inputs, shape, cf):
    """y within Y_ATOL and aux within AUX_ATOL of JAX's; at capacity 8.0 y
    within GATHER_TOL of the port's ``moe_apply`` (no pair drops there)."""
    jx, port = runs
    key = _key(shape, cf)
    full = port[shape][0][cf]["full"]
    np.testing.assert_allclose(full["y"].numpy(), jx[key + "y"], rtol=0, atol=Y_ATOL)
    assert abs(float(full["aux"]) - float(jx[key + "aux"])) <= AUX_ATOL
    if cf == 8.0:
        z = np.load(inputs)
        p = {k: torch.from_numpy(z[k]) for k in ("router", "w_gate", "w_up", "w_down")}
        p["shared"] = {k: torch.from_numpy(z["shared/" + k]) for k in ("w_gate", "w_up", "w_down")}
        y_ref, _ = moe.moe_apply(p, torch.from_numpy(z["x"]), R.moe_cfg(cf))
        torch.testing.assert_close(full["y"], y_ref, rtol=GATHER_TOL, atol=GATHER_TOL)


GRAD_LEAVES = ("router", "w_gate", "w_up", "w_down", "shared/w_gate", "shared/w_up",
               "shared/w_down", "x")


@pytest.mark.parametrize("shape,cf", CASES, ids=IDS)
def test_a2a_gradients_match_jax(runs, shape, cf):
    """Every leaf's gradient of sum(y**2) + 0.01 * aux, x's included, within
    GRAD_REL of jax.grad's relative to the leaf's largest magnitude: the
    router's and the shared experts' summed over the whole mesh, the
    experts' over the data axes."""
    jx, port = runs
    key = _key(shape, cf)
    full = port[shape][0][cf]["full"]
    got = {"x": full["x"], **full["grads"], **{f"shared/{k}": v
                                              for k, v in full["grads"]["shared"].items()}}
    for name in GRAD_LEAVES:
        want = jx[f"{key}grad/{name}"]
        err = np.abs(got[name].numpy() - want).max() / np.abs(want).max()
        assert err <= GRAD_REL, f"{name}: {err:.3e}"
        assert np.abs(want).max() > 0


@pytest.mark.parametrize("world", [1, 2])
def test_a2a_collectives_are_counted(runs, world):
    """One call's collectives through ``roofline.counts``: 3 all-to-alls
    (the rows, the meta buffer, the rows back) of M x cap rows over the
    model group and 2 all-reduces of the aux scalar (model, then data),
    their bytes and the ring model's link bytes at the groups' sizes; an
    all-gather and a reduce-scatter the same way."""
    _, port = runs
    shape = (1, world)
    d = reduced(get_config("deepseek-moe-16b")).d_model
    for res in port[shape]:
        for cf in CAPACITIES:
            n, size, link = res[cf]["counts"]
            t = B * S // world
            cap = max(8, int(np.ceil(t * 2 * cf / world / 8)) * 8)
            a2a = 2 * world * cap * d * 4 + world * cap * 2 * 4
            assert n == {"all-reduce": 2, "all-gather": 0, "reduce-scatter": 0,
                         "all-to-all": 3, "collective-permute": 0}
            assert size["all-to-all"] == a2a and size["all-reduce"] == 2 * 4
            want = (world - 1) / world * a2a + 2 * (world - 1) / world * 4
            assert link == pytest.approx(want, rel=1e-12, abs=0)
            if world == 1:
                assert link == 0
        # an all-gather of 8 x 3 float32 a rank into 8 world x 3, and the
        # reduce-scatter back: result bytes, and the ring model's
        n, size, link = res["gather_scatter_counts"]
        gathered, scattered = 8 * world * 3 * 4, 8 * 3 * 4
        assert n["all-gather"] == n["reduce-scatter"] == 1 and n["all-to-all"] == 0
        assert size["all-gather"] == gathered and size["reduce-scatter"] == scattered
        assert link == pytest.approx((world - 1) / world * gathered + (world - 1) * scattered,
                                     rel=1e-12, abs=0)


def test_a2a_refuses_plain_tensors_on_many_ranks(runs):
    _, port = runs
    for shape in MESHES[1:]:
        for res in port[shape]:
            assert res["plain_raises"] == [True, True]


# ---------------------------------------------------------------------------
# the MoE LM at world size 1, through the sharding context
# ---------------------------------------------------------------------------

LM_B, LM_S = 2, 32      # the JAX script's batch: 64 tokens, S a multiple of attn_chunk


@pytest.fixture(scope="module")
def lm(runs):
    """reduced(deepseek-moe-16b)'s LM from JAX's init (``chunked``), its
    batch, and JAX's loss, metrics and gradients under
    ``activation_sharding(mesh, lm_rules(mesh), moe_a2a=True)`` on a (1, 1)
    mesh (the subprocess's): the params and gradients by path."""
    jx, _ = runs
    params = {}
    for k, v in jx.items():
        if k.startswith("lm/param/"):
            *outer, leaf = k[len("lm/param/"):].split("/")
            node = params
            for part in outer:
                node = node.setdefault(part, {})
            node[leaf] = v
    return dict(params=params, batch={"tokens": jx["lm/tokens"], "labels": jx["lm/labels"]},
                loss=float(jx["lm/loss"]), ce=float(jx["lm/ce"]), aux=float(jx["lm/aux"]),
                grads={k[len("lm/grad/"):]: v for k, v in jx.items() if k.startswith("lm/grad/")})


@pytest.fixture
def mesh11(tmp_path):
    from repro_torch.distributed.context import lm_rules
    from repro_torch.distributed.mesh import make_mesh
    with R.process_group(tmp_path):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        yield mesh, lm_rules(mesh)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("remat", [False, True])
def test_loss_fn_under_a2a_context_matches_jax(lm, mesh11, remat, monkeypatch):
    """The port's loss_fn through moe_apply_a2a (moe_apply never called)
    equals JAX's under the same context: the loss, ce and moe_aux at rtol
    1e-5, every gradient leaf within GRAD_REL of its largest magnitude."""
    mesh, rules = mesh11
    cfg = dataclasses.replace(reduced(get_config("deepseek-moe-16b")), attn_impl="chunked",
                              remat=remat)
    params = tfm.params_from_numpy(lm["params"], "cpu")
    live = _flat(params)
    for v in live.values():
        v.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in lm["batch"].items()}

    def gather_path(*a, **k):
        raise AssertionError("moe_apply ran under moe_a2a=True")

    monkeypatch.setattr(moe, "moe_apply", gather_path)
    with shctx.activation_sharding(mesh, rules, moe_a2a=True):
        loss, metrics = tfm.loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, list(live.values()))
    assert loss.item() == pytest.approx(lm["loss"], rel=1e-5)
    assert metrics["ce"].item() == pytest.approx(lm["ce"], rel=1e-5)
    assert metrics["moe_aux"].item() == pytest.approx(lm["aux"], rel=1e-5)
    assert set(live) == set(lm["grads"])
    for (name, _), g in zip(live.items(), grads):
        want = lm["grads"][name]
        err = np.abs(g.numpy() - want).max() / np.abs(want).max()
        assert err <= GRAD_REL, f"{name}: {err:.3e}"


def test_remat_recomputes_the_a2a_routing(lm, mesh11):
    """Under remat each layer runs again in the backward, outside the
    caller's context: it routes through the all-to-all again, and each
    layer's dispatches equal its first pass's; count_drops counts both."""
    mesh, rules = mesh11
    cfg = dataclasses.replace(reduced(get_config("deepseek-moe-16b")), attn_impl="chunked",
                              remat=True)
    params = tfm.params_from_numpy(lm["params"], "cpu")
    leaves = tree_leaves(params)
    for v in leaves:
        v.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in lm["batch"].items()}
    with R.recorded_dispatch() as seen, moe.count_drops() as n:
        with shctx.activation_sharding(mesh, rules, moe_a2a=True):
            loss, _ = tfm.loss_fn(params, batch, cfg)
        torch.autograd.grad(loss, leaves)
    L = cfg.n_layers
    assert len(seen) == 2 * 3 * L
    fwd = [seen[3 * i: 3 * i + 3] for i in range(L)]
    again = [seen[3 * (L + i): 3 * (L + i) + 3] for i in range(L)][::-1]
    for a, b in zip(fwd, again):
        for (s1, k1), (s2, k2) in zip(a, b):
            assert torch.equal(s1, s2) and torch.equal(k1, k2)
    assert n.routed == 2 * L * LM_B * LM_S * cfg.moe.top_k
    assert n.dropped % 2 == 0


def test_decode_runs_the_gather_path_under_a2a(lm, mesh11, monkeypatch):
    """decode_step keeps moe_apply under moe_a2a=True, as JAX's does."""
    mesh, rules = mesh11
    cfg = dataclasses.replace(reduced(get_config("deepseek-moe-16b")), attn_impl="chunked")
    params = tfm.params_from_numpy(lm["params"], "cpu")
    calls = []
    monkeypatch.setattr(moe, "moe_apply_a2a", lambda *a, **k: calls.append(1))
    cache = tfm.init_cache(cfg, LM_B, 8, device="cpu")
    with torch.inference_mode(), shctx.activation_sharding(mesh, rules, moe_a2a=True):
        logits, _ = tfm.decode_step(params, cache, torch.zeros(LM_B, dtype=torch.long),
                                    torch.zeros(LM_B, dtype=torch.long), cfg)
    assert not calls and bool(torch.isfinite(logits).all())
