"""Planned steps of the port's ``launch/specs.py`` by value against the
JAX package's, on the CPU: the dense LM's train step
and prefill (reduced qwen3-0.6b: H=4 over Hkv=2, so at ``model`` = 2 or 4
the query heads split over the ranks and the KV heads do not, and each rank
slices the KV head its query heads read before the attention kernel's
wrapper runs) and its int8 decode. The cases, their argument values,
the JAX runs and the tolerances are ``tests/planned_cases.py``'s; the
port runs each case at world size 1 (mesh (1, 1), in this process) and 4
on gloo (meshes (2, 2) and (1, 4)).
"""
import pytest
import torch

import planned_cases as C

torch.set_num_threads(2)

IDS = ('lm-train', 'lm-prefill', 'int8-decode')


@pytest.fixture(scope="module")
def values():
    pytest.importorskip("jax")
    return {case: C.draw_values(case) for case in IDS}


@pytest.fixture(scope="module")
def world4(values, tmp_path_factory):
    """Started before JAX's runs, which it overlaps; waited for at the
    end, so that no rank outlives the module."""
    four = C.WorldFour(values, tmp_path_factory.mktemp("planned"))
    yield four
    four.result()


@pytest.fixture(scope="module")
def jax_runs(values, world4):
    return {case: C.jax_run(case, C._auto_mesh((1, 1)), values[case]) for case in IDS}


@pytest.mark.parametrize("case", IDS)
def test_planned_step_at_world_one_matches_jax(values, jax_runs, case):
    C.check(C.world_one(case, values[case]), jax_runs[case], case)


@pytest.mark.parametrize("mesh", C.MESHES, ids=["2x2", "1x4"])
@pytest.mark.parametrize("case", IDS)
def test_planned_step_at_world_four_matches_jax(jax_runs, world4, case, mesh):
    port, same_mesh = world4.result()
    want = same_mesh.get((case, mesh), jax_runs[case])
    C.check(port[(case, mesh)], want, case)
