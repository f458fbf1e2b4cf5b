"""The port's PairCollision (lagrangian/paircollision.py) against the JAX
package's on the CPU in float64, on the same seeded inputs: the parsed
model (moduli, wall planes and the per-patch wallLocal properties), and
`collide` over 12-20 calls on a head-on pair, an oblique pair (friction and
spin), a parcel bouncing off a floor, and a jittered lattice whose touching
neighbours overlap by EXACTLY equal amounts (ties for the K partner slots,
where jax.lax.top_k gives the lower index first). x, U, omega, rec_t and
wrec_t within 1e-10 relative; rec_id equal. Also: the pair terms computed in
blocks of 7 rows equal the one-block result bitwise, and the halving-tree
row sum is the same whatever the number of rows.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from firefoam_tpu.io import parse_string as jparse
from firefoam_tpu.lagrangian.paircollision import PairCollision as JPC
from firefoam_torch.io import parse_string as tparse
from firefoam_torch.lagrangian.paircollision import PairCollision as TPC, row_tree_sum

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)
TOL = 1e-10
RHO = 1000.0


class _Patch:
    def __init__(self, name, sl):
        self.name, self.ptype, self.slice = name, "wall", sl


class _Geom:
    """Two wall patches: a floor at y = 0 (4 faces) and a wall at x = 0
    (2 faces); the JAX package reads numpy arrays, the port tensors."""

    def __init__(self, tensors):
        self.patches = [_Patch("floor", slice(0, 4)), _Patch("side", slice(4, 6))]
        Sf = np.concatenate([np.tile([[0.0, -0.25, 0.0]], (4, 1)),
                             np.tile([[-0.5, 0.0, 0.0]], (2, 1))])
        Cf = np.asarray([[0.25, 0.0, 0.25], [0.75, 0.0, 0.25], [0.25, 0.0, 0.75],
                         [0.75, 0.0, 0.75], [0.0, 0.5, 0.25], [0.0, 0.5, 0.75]])
        cast = torch.as_tensor if tensors else np.asarray
        self.b_Sf, self.b_Cf = cast(Sf), cast(Cf)


class _NoWalls:
    patches = []


_DICT = """
collisionModel pairCollision;
pairCollisionCoeffs
{{
    nSubCycles {sub};
    nPairRecords {K};
    pairModelCoeffs {{ alpha 0.12; b 1.5; mu {mu}; cohesionEnergyDensity {coh};
                      useEquivalentSize false; }}
    wallModel {wall};
    wallModelCoeffs {{ alpha 0.12; b 1.5; mu 0.43; floor {{ youngsModulus 2e6;
                      poissonsRatio 0.3; alpha 0.2; b 1.5; mu 0.3; }} }}
}}
"""


def _models(walls=False, mu=0.52, coh=0.0, sub=40, K=2, wall="wallSpringSliderDashpot"):
    txt = _DICT.format(sub=sub, K=K, mu=mu, coh=coh, wall=wall)
    cp = "youngsModulus 1e6; poissonsRatio 0.35;"
    j = JPC.from_dict(jparse(txt), jparse(cp), _Geom(False) if walls else _NoWalls())
    t = TPC.from_dict(tparse(txt), tparse(cp), _Geom(True) if walls else _NoWalls())
    return j, t


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.max(np.abs(a - b), initial=0.0) / max(np.max(np.abs(b), initial=0.0), 1e-300))


def _run(jm, tm, st, n_calls, dt=2e-4, block_rows=None):
    """n_calls of collide on both sides; every state leaf compared after each."""
    cap = st["x"].shape[0]
    js = {k: jnp.asarray(v) for k, v in st.items()}
    ts = {k: torch.as_tensor(v) for k, v in st.items()}
    jc, tc = jm.init_state(cap, jnp.float64), tm.init_state(cap, torch.float64, "cpu")
    tm.block_rows = block_rows
    collide = jax.jit(jm.collide)  # as the JAX package's step runs it
    for i in range(n_calls):
        js, jc = collide(js, jc, RHO, dt)
        ts, tc = tm.collide(ts, tc, RHO, dt)
        for k in ("x", "U"):
            assert _rel(ts[k], js[k]) <= TOL, (i, k, _rel(ts[k], js[k]))
        for k in ("omega", "rec_t", "wrec_t"):
            assert _rel(tc[k], jc[k]) <= TOL, (i, k, _rel(tc[k], jc[k]))
        assert np.array_equal(_np(tc["rec_id"]), _np(jc["rec_id"])), i
    return ts, tc


def _pair(offset=0.0):
    return {
        "x": np.asarray([[0.0, 0.0, 0.0], [0.0025, offset, 0.0], [10.0, 10.0, 10.0],
                         [11.0, 11.0, 11.0]]),
        "U": np.asarray([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [0.0] * 3, [0.0] * 3]),
        "d": np.full(4, 2e-3), "nP": np.ones(4),
        "alive": np.asarray([True, True, False, False]),
    }


def test_parse_moduli_and_wall_planes():
    for wall in ("wallSpringSliderDashpot", "wallLocalSpringSliderDashpot"):
        jm, tm = _models(walls=True, wall=wall)
        for k in ("E_star", "G_star", "alpha", "b", "mu", "cohesion_density", "volume_factor"):
            assert getattr(tm, k) == getattr(jm, k), k
        assert (tm.sub_cycles, tm.n_records) == (jm.sub_cycles, jm.n_records)
        for k in ("wall_point", "wall_normal", "wall_E_star", "wall_G_star", "wall_alpha",
                  "wall_b", "wall_mu"):
            np.testing.assert_array_equal(getattr(tm, k), getattr(jm, k), err_msg=k)
    # the wallLocal model gives the floor its own properties
    assert tm.wall_mu.tolist() == [0.3, 0.43]
    sub = "collisionModel none;"
    assert TPC.from_dict(tparse(sub), tparse(""), _NoWalls()) is None


def test_head_on():
    jm, tm = _models()
    ts, _ = _run(jm, tm, _pair(), 12)
    U = _np(ts["U"])
    assert U[0, 0] < 0.0 < U[1, 0]  # rebound


def test_oblique_with_cohesion():
    jm, tm = _models(mu=0.5, coh=50.0)
    _, tc = _run(jm, tm, _pair(offset=1.2e-3), 12)
    assert np.abs(_np(tc["omega"])[0]).max() > 0.0  # friction spun the parcels


def test_wall_bounce_with_local_properties():
    jm, tm = _models(walls=True, wall="wallLocalSpringSliderDashpot", sub=20)
    st = {"x": np.asarray([[0.5, 1.1e-3, 0.5], [9e-4, 0.5, 0.4], [5.0, 5.0, 5.0]]),
          "U": np.asarray([[0.1, -0.5, 0.0], [-0.4, 0.0, 0.2], [0.0] * 3]),
          "d": np.full(3, 2e-3), "nP": np.ones(3), "alive": np.asarray([True, True, False])}
    ts, _ = _run(jm, tm, st, 20)
    U = _np(ts["U"])
    assert U[0, 1] > 0.0 and U[1, 0] > 0.0  # off the floor and off the side wall


def _lattice(n_side=4, seed=0):
    """A cubic lattice of 2^-9 m drops at a spacing 2^-20 m short of touching
    by their diameter: dyadic numbers, so every neighbour distance is exact
    and the overlaps tie; small random velocities; two dead slots."""
    rng = np.random.default_rng(seed)
    d = 2.0 ** -9
    idx = np.stack(np.meshgrid(*(np.arange(n_side),) * 3, indexing="ij"), -1).reshape(-1, 3)
    n = idx.shape[0]
    alive = np.ones(n, bool)
    alive[[5, 17]] = False
    return {"x": idx * (d - 2.0 ** -20), "U": rng.normal(0.0, 0.01, (n, 3)), "d": np.full(n, d),
            "nP": np.ones(n), "alive": alive}


@pytest.mark.parametrize("K", (2, 4))
def test_tied_overlaps_pick_the_lower_index(K):
    jm, tm = _models(sub=4, K=K)
    st = _lattice()
    # equal overlaps on the first call: each inner parcel has six partners at
    # exactly the same distance, more than K
    x = st["x"]
    dd = np.linalg.norm(x[:, None] - x[None], axis=-1)
    assert np.sum(dd[21] == 2.0 ** -9 - 2.0 ** -20) == 6
    _, tc = _run(jm, tm, st, 3, dt=1e-6)
    assert (_np(tc["rec_id"]) >= 0).all(axis=1).sum() > 0  # K partners held


def test_row_blocks_equal_one_block():
    jm, tm = _models(sub=3)
    st = _lattice(n_side=5, seed=1)
    a, ac = _run(jm, tm, st, 2, dt=1e-6)
    b, bc = _run(jm, tm, st, 2, dt=1e-6, block_rows=7)  # 125 rows in blocks of 7 and a 6
    assert tm.last_block_rows == 7
    for k in ("x", "U"):
        assert torch.equal(a[k], b[k]), k
    for k in ("omega", "rec_id", "rec_t", "wrec_t"):
        assert torch.equal(ac[k], bc[k]), k


def test_row_tree_sum():
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.normal(size=(9, 37)))
    s = row_tree_sum(x)
    np.testing.assert_allclose(s.numpy(), x.numpy().sum(1), rtol=1e-13)
    for r in range(9):  # a row's sum does not depend on the other rows
        assert torch.equal(row_tree_sum(x[r:r + 1]), s[r:r + 1])
