"""The Tensor hand-off (bindings.py) of the PyTorch port: the cases of
tests/test_bindings.py on the port, the zero-copy ``to_torch`` (the
column's own storage), and the packed export of a churned fantasy_vs
against the JAX package's (scripted replay, the same tables on both
sides): masks, counts and offsets exactly, the packed positions atol
1e-5 and hp atol 1e-3, the fantasy_vs slice's tolerances
(tests/test_torch_fantasy_vs.py)."""

import numpy as np
import pytest
import torch

from gpu_ecs_madrona_tpu.models import fantasy_vs as jfvs
from gpu_ecs_madrona_tpu_torch.bindings import Tensor, exported_tensor
from gpu_ecs_madrona_tpu_torch.models import collisions as col
from gpu_ecs_madrona_tpu_torch.models import fantasy_vs as fvs

from test_torch_fantasy_vs import patch_constants, random_script


def make_sim():
    return col.make_executor(
        col.CollisionsConfig(num_worlds=2, num_objects=8, max_pairs=64, seed=1), device="cpu")


def test_exported_tensor_roundtrip():
    sim = make_sim()
    t = exported_tensor(sim, 0)
    assert t.shape[0] == 2 and t.shape == tuple(t.values.shape)
    assert t.dtype == torch.float32
    n = t.to_numpy()
    assert isinstance(n, np.ndarray)
    assert np.isfinite(n[t.mask.numpy()]).all()
    n[...] = 123.0                    # a copy: the column is untouched
    assert not (t.values == 123.0).any()


def test_to_torch_zero_copy_cpu():
    sim = make_sim()
    t = exported_tensor(sim, 0)
    tt = t.to_torch()
    assert isinstance(tt, torch.Tensor)
    assert tt.shape == t.shape
    col_now = sim.mgr.column(sim.state, col.CubeObject, col.Translation)
    assert tt.data_ptr() == col_now.data_ptr()
    np.testing.assert_array_equal(tt.numpy(), t.to_numpy())


def test_from_torch():
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    assert Tensor.from_torch(x) is x
    d = {"hp": x}
    assert Tensor.from_torch(d)["hp"] is x


def test_torch_action_injection():
    """RL-loop pattern: learner writes actions via torch, sim consumes them
    (reference copyInExportedColumns + CudaSync flow)."""
    sim = make_sim()
    t = exported_tensor(sim, 0)
    actions = t.to_torch().clone()
    actions[:, :, 2] = 5.0
    sim.set_exported(0, Tensor.from_torch(actions))
    sim.step()
    t2 = exported_tensor(sim, 0).sync()
    vals = t2.values
    live = t2.mask
    # solver pushes may move z slightly; it must be near 5, not the old value
    assert ((vals[live][:, 2] - 5.0).abs() < 2.0).all()


def test_struct_component_tensor():
    sim = fvs.make_executor(fvs.FantasyVsConfig(num_worlds=2, num_dragons=3,
                                                num_knights=5, seed=2), device="cpu")
    t = exported_tensor(sim, 1)  # Dragon Health (struct -> dict)
    assert t.shape == (2, 3) and t.dtype == torch.float32
    tt = t.to_torch()
    assert set(tt.keys()) == {"hp"}
    assert (tt["hp"][t.mask] == 1000).all()
    hp = sim.mgr.column(sim.state, fvs.Dragon, fvs.Health)["hp"]
    assert tt["hp"].data_ptr() == hp.data_ptr()
    assert set(t.to_numpy()) == {"hp"}


def packed_check(vals, mask, packed, counts, offsets):
    assert (counts == mask.sum(axis=1)).all()
    assert (offsets == np.cumsum(counts) - counts).all()
    total = counts.sum()
    for w in range(mask.shape[0]):
        np.testing.assert_array_equal(packed[offsets[w]:offsets[w] + counts[w]],
                                      vals[w][mask[w]])
    assert (packed[total:] == 0).all()


def test_packed_export_roundtrip():
    """get_exported(slot, packed=True) on the port's random fantasy_vs:
    the reference's cross-world packed layout, against the padded view."""
    sim = fvs.make_executor(fvs.FantasyVsConfig(num_worlds=3, seed=5), device="cpu")
    sim.run(6)
    vals, mask = (x.numpy() for x in sim.get_exported(0))
    packed, counts, offsets = (x.numpy() for x in sim.get_exported(0, packed=True))
    packed_check(vals, mask, packed, counts, offsets)


@pytest.mark.parametrize("slot", [0, 1, 2, 3])
def test_packed_export_matches_jax(monkeypatch, slot):
    """A scripted fantasy_vs with damage high enough for churn, 12 ticks on
    both sides: every export, padded and packed, equals JAX's (counts and
    offsets exactly, values within the slice's tolerances)."""
    patch_constants(monkeypatch, jfvs, fvs)
    nd, nk, T = 5, 9, 12
    script = random_script(8, nd, nk, T)
    kw = dict(num_worlds=3, num_dragons=nd, num_knights=nk, seed=0, scripted=True,
              replicate_clamp_bug=True)
    jsim = jfvs.make_executor(jfvs.FantasyVsConfig(**kw), init_data=script, donate=False)
    psim = fvs.make_executor(fvs.FantasyVsConfig(**kw), init_data=script, device="cpu")
    jsim.run(T)
    psim.run(T)
    jmask = np.asarray(jsim.get_exported(slot)[1])
    pmask = psim.get_exported(slot)[1].numpy()
    np.testing.assert_array_equal(pmask, jmask)
    assert not np.asarray(jsim.get_exported(0)[1]).all()   # churn: dragons died
    jp = jsim.get_exported(slot, packed=True)
    pp = psim.get_exported(slot, packed=True)
    np.testing.assert_array_equal(pp[1].numpy(), np.asarray(jp[1]))
    np.testing.assert_array_equal(pp[2].numpy(), np.asarray(jp[2]))
    atol = 1e-5 if slot in (0, 2) else 1e-3       # positions / hp
    jv, pv = jp[0], pp[0]
    if isinstance(jv, dict):
        assert set(jv) == set(pv)
        jv, pv = jv["hp"], pv["hp"]
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=atol, rtol=0)
    vals = psim.get_exported(slot)[0]
    vals = vals["hp"] if isinstance(vals, dict) else vals
    packed_check(vals.numpy(), pmask, pv.numpy(), pp[1].numpy(), pp[2].numpy())
