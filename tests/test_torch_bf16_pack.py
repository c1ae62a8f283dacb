"""Port parity: ``MorphParams.pack_dtype="bfloat16"`` (the bf16 sweep pack).

- kernels 1 and 2, plain bf16 form (planes and UI/TC maps in bfloat16,
  1/n rounded to bfloat16, float32 arithmetic), against the reference's
  ``make_sweep_pack`` + ``fused_value_grad_precond_pack`` /
  ``fused_total_energy_pack`` at ``pack_dtype="bfloat16"`` in interpret
  mode, at windows 5 and 11 (and 17, the wide strip's first window):
  energy relative error <= 1e-5, grad and
  precond max abs <= 1e-5 * max|ref| (the same float32 arithmetic on the
  same bf16-rounded inputs, summed in other orders). The float32 form
  misses the reference's bf16 gradient by more than 1e-3 * max|ref|, so
  the comparison tells the forms apart;
- the shard forms in bf16 on a ragged split into 3 row blocks: their
  combined partials give the reference's whole-frame bf16 energy (1e-5
  relative), their owned rows its gradient and preconditioner (1e-5 of
  max|ref|);
- ``quantize_v_lin`` bitwise against the reference's (ties, |v| > 256);
- kernel 3's bf16 output (plain version): bitwise the float32 planes cast;
- the level solver (the reference's ``TestBf16Pack`` translation case,
  64 x 96, 60 iterations, ``backend="pallas"``, ``pallas_min_pixels=0``)
  against the reference's bf16 solve: medians of v_x within 1e-3 px and
  max |dv| <= BF16_SOLVE_ATOL (0.1 px, measured 0.052); the bf16 field
  differs from the port's float32 field and its median stays within
  0.05 px of it;
- ``pack_dtype_for``, the port's ``_resolve_backend`` for the pack dtype;
- under ``backend="auto"`` on the CPU the setting changes nothing, as in
  the reference: ``optimize_pair`` and ``cli pair`` bitwise as float32;
- ``kernels.REFERENCE_COUNTERPARTS["quantize_v_lin"]`` names the port's
  twin.
"""

import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videomorphing_tpu.config import MorphParams as JaxMorphParams
from videomorphing_tpu.pallas import sweep as jps
from videomorphing_tpu.solver import descent as jd
from videomorphing_tpu.solver.ctf import optimize_pair as jax_optimize_pair
from videomorphing_tpu.solver.energy import make_level_data
from videomorphing_tpu_torch.config import MorphParams
from videomorphing_tpu_torch.interop import level_data_from_numpy
from videomorphing_tpu_torch.kernels import REFERENCE_COUNTERPARTS
from videomorphing_tpu_torch.kernels import sweep as ks
from videomorphing_tpu_torch.kernels import warp as kw
from videomorphing_tpu_torch.solver import descent as td
from videomorphing_tpu_torch.solver.ctf import optimize_pair
from videomorphing_tpu_torch.solver.energy import LevelData

torch.set_num_threads(2)
BF16 = torch.bfloat16
# max |dv| between the port's and the reference's 60-iteration bf16 level
# solves: measured 0.052 px (p99 8.0e-3, median 1.4e-4 px), where the two
# float32 solves of the same case differ by at most 9.8e-4 px
# (scripts/compare_bf16_fields.py --level). Rounding the
# linearization point to bf16 amplifies the float32 differences: a change
# of one float32 ulp in v next to a rounding boundary moves v_lin by a bf16
# step, 2^-7 px at |v| in [1, 2), and the warps with it
BF16_SOLVE_ATOL = 0.1


def _case(h, w, seed, c=3):
    """``tests/test_torch_sweep.py``'s case, with ``v_lin`` rounded to bf16
    (the solver's linearization points are)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    v_lin = np.stack([2.0 * np.sin(yy / 9.0), 1.5 * np.cos(xx / 11.0)], -1).astype(np.float32)
    v = (v_lin + 0.3 * rng.standard_normal((h, w, 2))).astype(np.float32)
    arrs = dict(
        i0=rng.random((h, w, c), dtype=np.float32),
        i1=rng.random((h, w, c), dtype=np.float32),
        ui_w=rng.random((h, w, 1), dtype=np.float32),
        ui_v=(v + 0.1 * rng.standard_normal((h, w, 2))).astype(np.float32),
        tc_w=rng.random((h, w, 1), dtype=np.float32),
        tc_v=(v + 0.5 * rng.standard_normal((h, w, 2))).astype(np.float32),
    )
    v_lin = torch.from_numpy(v_lin).to(BF16).float().numpy()
    return arrs, v_lin, v


def _params(window):
    return MorphParams(pack_dtype="bfloat16") if window == 5 else MorphParams(
        pack_dtype="bfloat16", ssim_window=window, ssim_sigma=1.5)


def _jp(p):
    return JaxMorphParams(**dataclasses.asdict(p))


def _reference_bf16(arrs, v_lin, v, p):
    """(E, grad, precond, E from kernel 2) of the reference's bf16 pack, in
    interpret mode."""
    jp = _jp(p)
    data = make_level_data(*(jnp.asarray(arrs[k]) for k in ("i0", "i1", "ui_w", "ui_v", "tc_w", "tc_v")))
    wb = jd.warp_bundle(jnp.asarray(v_lin), data)
    x = jps.make_sweep_pack(wb.w0, wb.dw0, wb.w1, wb.dw1, wb.v_lin, data, jp)
    h, w, c = arrs["i0"].shape
    e, g, pc = jps.fused_value_grad_precond_pack(x, jnp.asarray(v), (h, w), c, jp, interpret=True)
    et = jps.fused_total_energy_pack(x, jnp.asarray(v), (h, w), c, jp, interpret=True)
    return float(e), np.asarray(g), np.asarray(pc), float(et)


# widths of every residue mod 4 (33 x 57 and 33 x 59 with an odd h w): the
# bf16 kernels take each element's half of its 4-byte word from the parity
# of its flat index, and the card holds them to this plain version on the
# same kinds of shapes
@pytest.mark.parametrize(
    "window, hw",
    [pytest.param(k, (40, 56), id=str(k)) for k in (5, 11)]
    + [pytest.param(k, (33, w), id=f"{k}-33x{w}") for k in (5, 11) for w in (57, 58, 59)]
    + [pytest.param(17, (33, 58), id="17-33x58")],
)
def test_plain_bf16_sweeps_match_the_reference(window, hw):
    p = _params(window)
    arrs, v_lin, v = _case(*hw, 0)
    e_r, g_r, p_r, et_r = _reference_bf16(arrs, v_lin, v, p)
    data = level_data_from_numpy(**arrs)
    t = torch.from_numpy
    planes = kw.halfway_warp(data.i0, data.i1, t(v_lin), BF16)
    assert planes.dtype == BF16
    e, g, pc = ks.sweep_grad(planes, t(v_lin), t(v), ks.pack_maps(data, BF16), p)
    et = ks.sweep_energy(planes, t(v_lin), t(v), ks.pack_maps(data, BF16), p)
    assert abs(float(e) - e_r) <= 1e-5 * abs(e_r)
    assert abs(float(et) - et_r) <= 1e-5 * abs(et_r)
    assert np.max(np.abs(g.numpy() - g_r)) <= 1e-5 * np.max(np.abs(g_r))
    assert np.max(np.abs(pc.numpy() - p_r)) <= 1e-5 * np.max(np.abs(p_r))
    # the float32 form computes another function: its gradient misses the
    # reference's bf16 one by far more than the gate
    planes32 = kw.halfway_warp(data.i0, data.i1, t(v_lin))
    _, g32, _ = ks.sweep_grad(planes32, t(v_lin), t(v), data, p)
    assert np.max(np.abs(g32.numpy() - g_r)) > 1e-3 * np.max(np.abs(g_r))
    assert ks.sweep_grad.launches == ks.sweep_grad.launches_bf16 == 0


def test_bf16_planes_off_a_4_byte_boundary_raise():
    """The bf16 kernels copy the aligned 4-byte word that holds each plane
    element, so the wrapper refuses a stack that starts on a half word."""
    arrs, v_lin, v = _case(4, 5, 1)
    data = ks.pack_maps(level_data_from_numpy(**arrs), BF16)
    buf = torch.zeros(18 * 4 * 5 + 2, dtype=BF16)
    t = torch.from_numpy
    assert buf.data_ptr() % 4 == 0
    assert ks._check(buf[2:].view(18, 4, 5), t(v_lin), t(v), data) == (4, 5, 3, BF16)
    with pytest.raises(ValueError, match="4-byte"):
        ks._check(buf[1:-1].view(18, 4, 5), t(v_lin), t(v), data)
    # float32 planes are aligned by their type
    f32 = torch.zeros(18 * 4 * 5, dtype=torch.float32).view(18, 4, 5)
    assert ks._check(f32, t(v_lin), t(v), ks.pack_maps(data, torch.float32))[3] == torch.float32


def test_mixed_plane_and_map_dtypes_raise():
    arrs, v_lin, v = _case(12, 16, 1)
    data = level_data_from_numpy(**arrs)
    t = torch.from_numpy
    planes = kw.halfway_warp(data.i0, data.i1, t(v_lin), BF16)
    p = _params(5)
    with pytest.raises(TypeError, match="bfloat16"):
        ks.sweep_grad(planes, t(v_lin), t(v), data, p)
    with pytest.raises(TypeError, match="bfloat16"):
        ks.sweep_energy(planes.float(), t(v_lin), t(v), ks.pack_maps(data, BF16), p)
    with pytest.raises(TypeError):
        kw.halfway_warp(data.i0, data.i1, t(v_lin), torch.float16)


def test_shard_forms_bf16_give_the_reference_frame():
    """Ragged split of 40 rows into 13, 13 and 14 owned rows at window 5."""
    p = _params(5)
    h, w = 40, 56
    arrs, v_lin, v = _case(h, w, 2)
    e_r, g_r, p_r, _ = _reference_bf16(arrs, v_lin, v, p)
    data = level_data_from_numpy(**arrs)
    halo = ks.shard_reach(p)
    pad = lambda a: np.pad(a, ((halo, halo), (0, 0), (0, 0)))
    acc = np.zeros(4, np.float32)
    acc_e = np.zeros(4, np.float32)
    grads, preconds = [], []
    for lo, hi in ((0, 13), (13, 26), (26, 40)):
        row0 = lo - halo
        ext = lambda a: torch.from_numpy(pad(a)[lo:hi + 2 * halo].copy())
        vl_e, v_e = ext(v_lin), ext(v)
        planes = kw.halfway_warp_rows(data.i0, data.i1, vl_e, row0, BF16)
        assert torch.equal(planes, kw.halfway_warp_rows(data.i0, data.i1, vl_e, row0).to(BF16))
        maps = (m[lo:hi] for m in (data.ui_w, data.ui_v, data.tc_w, data.tc_v))
        blk = ks.pack_maps(LevelData(data.i0, data.i1, *maps), BF16)
        parts, g, pc = ks.sweep_grad_shard(planes, vl_e, v_e, blk, p, row0, h, halo)
        acc = acc + parts.numpy()
        acc_e = acc_e + ks.sweep_energy_shard(planes, vl_e, v_e, blk, p, row0, h, halo).numpy()
        grads.append(g.numpy())
        preconds.append(pc.numpy())
    for parts in (acc, acc_e):
        e_shard = float(ks.combine_parts(parts, p, h * w, 3))
        assert abs(e_shard - e_r) <= 1e-5 * abs(e_r)
    assert np.max(np.abs(np.concatenate(grads) - g_r)) <= 1e-5 * np.max(np.abs(g_r))
    assert np.max(np.abs(np.concatenate(preconds) - p_r)) <= 1e-5 * np.max(np.abs(p_r))
    assert ks.sweep_grad_shard.launches_bf16 == ks.sweep_energy_shard.launches_bf16 == 0


def test_quantize_v_lin_is_the_reference_rounding():
    rng = np.random.default_rng(3)
    v = (rng.standard_normal((17, 23, 2)) * np.array([3.0, 300.0])).astype(np.float32)
    # exact ties of bf16 (halfway between two bf16 values) around 1, 257 and 300.5
    ties = np.array([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, 257.0, 259.0, -300.5, 513.0, -1.0 - 2.0 ** -8],
                    np.float32)
    v.reshape(-1)[:ties.size] = ties
    p = MorphParams(pack_dtype="bfloat16")
    got = ks.quantize_v_lin(torch.from_numpy(v), p)
    ref = np.asarray(jps.quantize_v_lin(jnp.asarray(v), _jp(p)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not np.array_equal(got.numpy(), v)
    same = ks.quantize_v_lin(torch.from_numpy(v), MorphParams())
    np.testing.assert_array_equal(same.numpy(), v)
    with pytest.raises(ValueError, match="pack_dtype"):
        ks.quantize_v_lin(torch.from_numpy(v), MorphParams(pack_dtype="float16"))


def test_warp_bf16_output_is_the_float32_planes_cast():
    arrs, v_lin, _ = _case(24, 31, 4)
    data = level_data_from_numpy(**arrs)
    v = torch.from_numpy(v_lin)
    got = kw.halfway_warp(data.i0, data.i1, v, BF16)
    ref = kw.halfway_warp_plain(data.i0, data.i1, v)
    assert got.dtype == BF16 and torch.equal(got, ref.to(BF16))
    rows = kw.halfway_warp_rows(data.i0, data.i1, v[5:15], -3, BF16)
    assert torch.equal(rows, kw.halfway_warp_rows_plain(data.i0, data.i1, v[5:15], -3).to(BF16))
    assert kw.halfway_warp.launches_bf16 == kw.halfway_warp_rows.launches_bf16 == 0


def _translation_case():
    """The reference's ``TestBf16Pack.test_level_solver_converges_bf16``
    inputs: a 64 x 96 texture shifted by -/+ 1.5 px."""
    rng = np.random.default_rng(5)
    h, w = 64, 96
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    tex = np.zeros((h, w), np.float32)
    for per in (9.0, 17.0, 31.0):
        tex += np.sin(2 * np.pi * xx / per + rng.uniform(0, 6)) * np.cos(2 * np.pi * yy / per + rng.uniform(0, 6))
    tex = 0.5 + tex / 6.0
    img = np.stack([tex, 0.9 * tex, 0.8 * tex], -1)

    def shift(dx):
        xs = np.clip(xx + dx, 0, w - 1).astype(np.int32)
        return img[np.arange(h)[:, None], xs].astype(np.float32)

    return shift(-1.5), shift(1.5)


def test_level_solver_bf16_matches_the_reference():
    from videomorphing_tpu.solver.descent import make_level_solver as jax_level_solver
    from videomorphing_tpu.solver.energy import make_level_data as jax_level_data
    from videomorphing_tpu_torch.solver.energy import make_level_data as port_level_data

    i0, i1 = _translation_case()
    h, w = i0.shape[:2]
    fields = {}
    for pd in ("float32", "bfloat16"):
        p = MorphParams(pack_dtype=pd, backend="pallas", pallas_min_pixels=0)
        v, st = td.make_level_solver(p, 60)(torch.zeros((h, w, 2)),
                                             port_level_data(torch.from_numpy(i0), torch.from_numpy(i1)))
        assert st.e_final < st.e0
        fields[pd] = v.numpy()
    p16 = _jp(MorphParams(pack_dtype="bfloat16", backend="pallas", pallas_min_pixels=0))
    v_ref, st_ref = jax_level_solver(p16, 60)(jnp.zeros((h, w, 2), jnp.float32),
                                             jax_level_data(jnp.asarray(i0), jnp.asarray(i1)))
    v_ref = np.asarray(v_ref)
    med = lambda f: float(np.median(f[8:-8, 8:-8, 1]))
    assert abs(med(fields["bfloat16"]) - med(v_ref)) <= 1e-3
    assert np.max(np.abs(fields["bfloat16"] - v_ref)) <= BF16_SOLVE_ATOL
    assert not np.array_equal(fields["bfloat16"], fields["float32"])
    assert med(fields["float32"]) < -0.5
    assert abs(med(fields["bfloat16"]) - med(fields["float32"])) < 0.05


CUDA = torch.device("cuda")
CPU = torch.device("cpu")


@pytest.mark.parametrize(
    "backend, device, hw, want",
    [
        ("jnp", CPU, (128, 128), torch.float32),
        ("jnp", CUDA, (128, 128), torch.float32),
        ("pallas", CPU, (8, 8), BF16),
        ("pallas", CUDA, (8, 8), BF16),
        ("auto", CPU, (256, 256), torch.float32),
        ("auto", CUDA, (128, 128), BF16),
        ("auto", CUDA, (127, 128), torch.float32),
        ("auto", "cuda:0", (64, 256), BF16),
    ],
)
def test_pack_dtype_for(backend, device, hw, want):
    p = MorphParams(backend=backend, pack_dtype="bfloat16")
    assert td.pack_dtype_for(p, *hw, device) == want
    assert td.pack_dtype_for(dataclasses.replace(p, pack_dtype="float32"), *hw, device) == torch.float32


def test_pack_dtype_for_raises_where_the_reference_reads():
    with pytest.raises(ValueError, match="backend"):
        td.pack_dtype_for(MorphParams(backend="xla"), 64, 64, CPU)
    bad = MorphParams(pack_dtype="float16")
    with pytest.raises(ValueError, match="pack_dtype"):
        td.pack_dtype_for(dataclasses.replace(bad, backend="pallas"), 64, 64, CPU)
    with pytest.raises(ValueError, match="pack_dtype"):
        td.pack_dtype_for(bad, 128, 128, CUDA)
    # the reference reads pack_dtype on its Pallas path only
    assert td.pack_dtype_for(bad, 128, 128, CPU) == torch.float32
    assert td.pack_dtype_for(bad, 127, 128, CUDA) == torch.float32
    assert td.pack_dtype_for(dataclasses.replace(bad, backend="jnp"), 128, 128, CUDA) == torch.float32


def test_spatial_solver_takes_the_block_rows_and_float32_with_batch_axis():
    """The row-sharded solve decides on the block's owned rows (here 2
    blocks of 20 rows under ``pallas_min_pixels`` = 1000 > 20 x 48: the
    setting is read) and with ``batch_axis`` always solves in float32."""
    from videomorphing_tpu_torch.parallel.mesh import make_mesh
    from videomorphing_tpu_torch.parallel.spatial import make_spatial_level_solver
    from videomorphing_tpu_torch.solver.energy import make_level_data as port_level_data

    rng = np.random.default_rng(6)
    i0 = torch.from_numpy(rng.random((40, 48, 3), dtype=np.float32))
    i1 = torch.roll(i0, 1, 1)
    data = port_level_data(i0, i1)
    v0 = torch.zeros((40, 48, 2))
    mesh = make_mesh((2,), ("y",), devices=["cpu", "cpu"])
    solve = lambda p: make_spatial_level_solver(p, 4, mesh)(v0, data)[0]
    v32 = solve(MorphParams(backend="pallas"))
    v16 = solve(MorphParams(backend="pallas", pack_dtype="bfloat16"))
    assert not torch.equal(v16, v32)
    # "auto" on the CPU, and pallas_min_pixels is no rule for "pallas"
    assert torch.equal(solve(MorphParams(pack_dtype="bfloat16")), v32)
    assert torch.equal(solve(MorphParams(backend="pallas", pack_dtype="bfloat16", pallas_min_pixels=10 ** 6)), v16)
    with pytest.raises(ValueError, match="pack_dtype"):
        solve(MorphParams(backend="pallas", pack_dtype="int8"))
    mesh2 = make_mesh((1, 2), ("batch", "y"), devices=["cpu", "cpu"])
    batch = lambda p: make_spatial_level_solver(p, 4, mesh2, batch_axis="batch")(v0[None], LevelData(
        *(x[None] for x in data)))[0][0]
    assert torch.equal(batch(MorphParams(backend="pallas", pack_dtype="bfloat16")), v32)
    assert torch.equal(batch(MorphParams(backend="pallas", pack_dtype="int8")), v32)


def _fault_pair():
    rng = np.random.default_rng(0)
    i0 = rng.random((40, 56, 3), np.float32)
    return i0, np.roll(i0, 1, axis=1)


def test_bf16_under_auto_on_the_cpu_is_the_float32_solve():
    """The reference solves ``pack_dtype="bfloat16"`` under ``"auto"`` on
    the CPU in float32 (its jnp path); the port did raise."""
    i0, i1 = _fault_pair()
    kw_ = dict(n_levels=2, iters_coarse=5, iters_fine=5)
    got16 = optimize_pair(torch.from_numpy(i0), torch.from_numpy(i1), params=MorphParams(pack_dtype="bfloat16", **kw_))
    got32 = optimize_pair(torch.from_numpy(i0), torch.from_numpy(i1), params=MorphParams(**kw_))
    assert torch.equal(got16.v, got32.v)
    ref = jax_optimize_pair(jnp.asarray(i0), jnp.asarray(i1), params=JaxMorphParams(pack_dtype="bfloat16", **kw_))
    assert np.max(np.abs(np.asarray(ref.v) - got16.v.numpy())) <= 1e-3


def test_cli_pair_with_bf16_pack_on_the_cpu(tmp_path):
    """``cli pair --set morph.pack_dtype=bfloat16 --device cpu`` exits 0
    and writes the bytes of the same command without the setting."""
    from videomorphing_tpu_torch.io import save_image

    i0, i1 = _fault_pair()
    save_image(str(tmp_path / "a.png"), i0)
    save_image(str(tmp_path / "b.png"), i1)
    base = [sys.executable, "-m", "videomorphing_tpu_torch.cli", "pair", str(tmp_path / "a.png"),
            str(tmp_path / "b.png"), "--frames", "3", "--device", "cpu", "--levels", "2", "--iters", "5"]
    outs = []
    for extra, name in (([], "f32.vmc"), (["--set", "morph.pack_dtype=bfloat16"], "bf16.vmc")):
        out = tmp_path / name
        proc = subprocess.run(base + extra + ["--out", str(out)], capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]


def test_quantize_v_lin_has_the_port_twin():
    assert REFERENCE_COUNTERPARTS["quantize_v_lin"] == "videomorphing_tpu_torch.kernels.sweep.quantize_v_lin"
