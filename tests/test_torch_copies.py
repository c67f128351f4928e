"""The port's copies of the JAX package's JAX-free modules equal the
originals: their code (the colour models, the quantize step, the image
utilities, the order prototype, the scaling-floor canary, the oracle
codec and the bit packing included), the manifest functions and
``as_numpy_image``, filter taps, subband geometry, queue bounds, the bit machines' geometry tables, the max_n
threshold table, colour constants and the settings containers; the native
scheduler's C++ sources, its ctypes bindings and its outputs; the metadata
trace's rect and node tables; the planner's numpy functions."""

import ast
import dataclasses
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from spiht_tpu.codec import device_decoder as jdd
from spiht_tpu.codec import device_encoder as jde
from spiht_tpu.codec import meta_expand as jme
from spiht_tpu.codec import oracle as jor
from spiht_tpu.codec import order_prototype as jop
from spiht_tpu.codec import planning as jplan
from spiht_tpu.codec import tree_bounds as jtb
from spiht_tpu.native import runtime as jrt
from spiht_tpu import interop as jinterop
from spiht_tpu.parallel import distributed as jdist
from spiht_tpu.parallel import scaling_check as jsc
from spiht_tpu.color import models as jcm
from spiht_tpu.ops import bitpack as jbp
from spiht_tpu.ops import quantize as jq
from spiht_tpu import settings as jset
from spiht_tpu import utils as jutils
from spiht_tpu.wavelets import _coif_tables as jcoif
from spiht_tpu.wavelets import filters as jf
from spiht_tpu.wavelets import geometry as jgeo
from spiht_tpu.wavelets import ref_dwt as jref

from spiht_tpu_torch import settings as tset
from spiht_tpu_torch.codec import geom as tgeom
from spiht_tpu_torch.codec import maxn as tmaxn
from spiht_tpu_torch.codec import meta_expand as tme
from spiht_tpu_torch.codec import oracle as tor
from spiht_tpu_torch.codec import order_prototype as top
from spiht_tpu_torch.codec import planning as tplan
from spiht_tpu_torch.codec import tree_bounds as ttb
from spiht_tpu_torch.native import runtime as trt
from spiht_tpu_torch import interop as tinterop
from spiht_tpu_torch.parallel import distributed as tdist
from spiht_tpu_torch.parallel import scaling_check as tsc
from spiht_tpu_torch.color import models as tcm
from spiht_tpu_torch.ops import bitpack as tbp
from spiht_tpu_torch.ops import quantize as tq
from spiht_tpu_torch import utils as tutils
from spiht_tpu_torch.wavelets import _coif_tables as tcoif
from spiht_tpu_torch.wavelets import filters as tf
from spiht_tpu_torch.wavelets import geometry as tgeo
from spiht_tpu_torch.wavelets import ref_dwt as tref

torch.set_num_threads(1)

GEOMS = [
    # (c, h, w, ll_h, ll_w)
    (1, 16, 16, 4, 4),
    (3, 24, 32, 6, 8),
    (2, 34, 18, 4, 2),
    (1, 19, 19, 5, 5),
    (2, 21, 13, 3, 2),
    (3, 89, 89, 5, 5),
    (3, 70, 70, 12, 12),
]


# db21-db38 (mpmath root finding) and coif5 (Gauss-Newton) take ~20 s to
# derive per package; their taps are covered by test_copied_code_identical,
# which holds the deriving code itself equal
_HEAVY = {f"db{n}" for n in range(21, 39)} | {"coif5"}


def _code(module) -> str:
    """The module's AST without docstrings."""
    tree = ast.parse(inspect.getsource(module))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("pair", [
    (jf, tf), (jcoif, tcoif), (jref, tref), (jgeo, tgeo), (jtb, ttb),
    (jset, tset), (jcm, tcm), (jq, tq), (jutils, tutils), (jop, top),
    (jsc, tsc), (jor, tor), (jbp, tbp),
], ids=lambda p: p[0].__name__)
def test_copied_code_identical(pair):
    assert _code(pair[0]) == _code(pair[1])


def test_wavelist_identical():
    assert tf.wavelist() == jf.wavelist()


@pytest.mark.parametrize(
    "name", [n for n in jf.wavelist() if n not in _HEAVY]
)
def test_filter_taps_identical(name):
    a, b = jf.build_wavelet(name), tf.build_wavelet(name)
    for field in ("dec_lo", "dec_hi", "rec_lo", "rec_hi"):
        assert np.array_equal(
            np.asarray(getattr(a, field)), np.asarray(getattr(b, field))
        ), (name, field)


def test_dwt_helpers_identical():
    for n in (1, 2, 7, 64, 513):
        for f in (2, 6, 10, 18):
            assert tf.dwt_max_level(n, f) == jf.dwt_max_level(n, f)
            for mode in ("reflect", "periodization", "zero"):
                assert tf.dwt_coeff_len(n, f, mode) == jf.dwt_coeff_len(
                    n, f, mode
                )


@pytest.mark.parametrize(
    "wavelet,mode", [("bior2.2", "reflect"), ("bior4.4", "symmetric"),
                     ("db3", "periodization"), ("haar", "zero")]
)
def test_slices_identical(wavelet, mode):
    js = jset.SpihtSettings(wavelet=wavelet, mode=mode)
    ts = tset.SpihtSettings(wavelet=wavelet, mode=mode)
    for h, w in ((64, 64), (33, 47), (512, 512), (17, 90)):
        for level in (None, 1, 3):
            assert tgeo.get_slices_and_h_w(h, w, ts, level) == (
                jgeo.get_slices_and_h_w(h, w, js, level)
            )
            assert tref.wavedecn_shapes(
                (1, h, w), wavelet, mode, level, (-2, -1)
            ) == jref.wavedecn_shapes((1, h, w), wavelet, mode, level,
                                      (-2, -1))


@pytest.mark.parametrize("geo", GEOMS)
def test_queue_bounds_identical(geo):
    c, h, w, ll_h, ll_w = geo
    a, b = jtb.queue_bounds(*geo), ttb.queue_bounds(*geo)
    for f in a.__slots__:
        assert getattr(a, f) == getattr(b, f), f
    for cap_words in (1, 64, 8192, 10**6):
        assert ttb.narrowed_caps(b, cap_words) == jtb.narrowed_caps(
            a, cap_words
        )


@pytest.mark.parametrize("geo", GEOMS)
def test_dec_geom_identical(geo):
    a, b = jdd._dec_geom(*geo), tgeom.dec_geom(*geo)
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], int):
            assert a[k] == b[k], k
        else:
            assert np.array_equal(np.asarray(a[k]), b[k]), k


@pytest.mark.parametrize("n", [0, 1, 5, 8, 33])
def test_words_of_identical(n):
    data = bytes(np.random.default_rng(n).integers(0, 256, n, np.uint8))
    cap = max((n * 8 + 31) // 32, 1) + 1
    assert np.array_equal(
        np.asarray(jdd._words_of(data, cap)), tgeom.words_of(data, cap)
    )


def test_max_n_thresholds_identical():
    assert tmaxn.max_n_thresholds() == jde._max_n_thresholds()


def test_colour_constants_identical():
    """Every module-level matrix, vector and number of the colour models,
    derived ones (inverses, CAM16/CAM02 viewing terms) included."""
    names = [k for k, v in vars(jcm).items()
             if isinstance(v, (np.ndarray, float, tuple))]
    assert len(names) > 60
    for name in names:
        a, b = getattr(jcm, name), getattr(tcm, name)
        assert np.array_equal(np.asarray(a), np.asarray(b)), name
    assert tcm._LUO2006 == jcm._LUO2006
    assert tcm.SUPPORTED_MODELS == jcm.SUPPORTED_MODELS


def test_settings_identical():
    assert tset.ENCODER_DECODER_VERSION == jset.ENCODER_DECODER_VERSION
    for cls in ("SpihtSettings", "EncodingResult"):
        fa = [(f.name, f.default) for f in
              dataclasses.fields(getattr(jset, cls))]
        fb = [(f.name, f.default) for f in
              dataclasses.fields(getattr(tset, cls))]
        assert fa == fb
    er = tset.EncodingResult(b"\x01\x02", 5, 6, 3, 9, 2)
    assert jset.EncodingResult.from_dict(er.to_dict()).to_dict() == er.to_dict()


@pytest.mark.parametrize("name", ["spiht_kernel.cpp", "dwt_kernel.cpp"])
def test_native_sources_identical(name):
    src = Path(jrt.__file__).parent / name
    dst = Path(trt.__file__).parent / name
    assert src.read_bytes() == dst.read_bytes()


def test_native_bindings_identical():
    def tree(obj):
        return ast.dump(ast.parse(inspect.getsource(obj)))

    assert tree(trt._Kernel) == tree(jrt._Kernel)
    assert trt._EXT_MODES == jrt._EXT_MODES


def test_native_library_is_the_ports_own():
    """The port builds its own library under spiht_tpu_torch/build and
    never loads the JAX package's."""
    root = Path(trt.__file__).resolve().parent.parent
    assert trt._so_path().parent == root / "build"
    assert "spiht_tpu_torch" in str(trt._so_path())


@pytest.mark.parametrize("geo", [(3, 24, 32, 6, 8), (1, 19, 19, 5, 5),
                                 (2, 34, 18, 4, 2)])
def test_native_outputs_identical(geo):
    """Encode (single and batch), decode (single, batch, with metadata)
    and the maps of both packages' native schedulers agree."""
    c, h, w, ll_h, ll_w = geo
    rng = np.random.default_rng(sum(geo))
    arrs = [(rng.standard_normal((c, h, w)) * s).astype(np.int32)
            for s in (900, 7)]
    jn, tn = jrt.load(), trt.load()
    for a in arrs:
        for mb in (2**62, 333):
            assert tn.encode(a, ll_h, ll_w, mb) == jn.encode(a, ll_h, ll_w, mb)
        for x, y in zip(tn.compute_maps(a, ll_h, ll_w),
                        jn.compute_maps(a, ll_h, ll_w)):
            np.testing.assert_array_equal(x, y)
    mbs = [2**62, 1001]
    enc = tn.encode_batch(arrs, [ll_h] * 2, [ll_w] * 2, mbs)
    assert enc == jn.encode_batch(arrs, [ll_h] * 2, [ll_w] * 2, mbs)
    datas = [d[:cut] for (d, _), cut in zip(enc, (None, 40))]
    ns = [m for _, m in enc]
    for d, n in zip(datas, ns):
        np.testing.assert_array_equal(tn.decode(d, n, c, h, w, ll_h, ll_w),
                                      jn.decode(d, n, c, h, w, ll_h, ll_w))
        top = [(0, ll_h), (0, ll_w)]
        other = [[[(0, ll_h), (ll_w, 2 * ll_w)], [(ll_h, 2 * ll_h), (0, ll_w)],
                  [(ll_h, 2 * ll_h), (ll_w, 2 * ll_w)]]]
        for x, y in zip(
            tn.decode_with_metadata(d, n, c, h, w, ll_h, ll_w, top, other),
            jn.decode_with_metadata(d, n, c, h, w, ll_h, ll_w, top, other),
        ):
            np.testing.assert_array_equal(x, y)
    args = (datas, ns, [c] * 2, [h] * 2, [w] * 2, [ll_h] * 2, [ll_w] * 2)
    for x, y in zip(tn.decode_batch(*args), jn.decode_batch(*args)):
        np.testing.assert_array_equal(x, y)


def _wire(level, ll_h, ll_w):
    """(top_slice, other_slices) of a dyadic packing of ``level`` levels."""
    top = ((0, ll_h), (0, ll_w))
    other = []
    h, w = ll_h, ll_w
    for _ in range(level):
        other.append((((0, h), (w, 2 * w)), ((h, 2 * h), (0, w)),
                      ((h, 2 * h), (w, 2 * w))))
        h, w = 2 * h, 2 * w
    return top, tuple(other)


@pytest.mark.parametrize("level,ll", [(0, (4, 4)), (2, (6, 8)), (3, (12, 12))])
def test_rect_table_identical(level, ll):
    wire = _wire(level, *ll)
    for slices in (wire, None):
        np.testing.assert_array_equal(
            tgeom.rect_table(level, *ll, slices),
            jdd._rect_table(level, *ll, slices))


@pytest.mark.parametrize("c,level,ll", [(1, 2, (4, 4)), (3, 2, (6, 8)),
                                        (2, 3, (12, 12))])
def test_static_node_tables_identical(c, level, ll):
    """The port keeps filter and depth per node and computes the local
    position per trace row; applied to every node, it gives the JAX
    package's per-node tables exactly."""
    h, w = ll[0] << level, ll[1] << level
    wire = _wire(level, *ll)
    key = tuple(map(tuple, jdd._rect_table(level, *ll, wire).reshape(-1, 4)))
    jfilt, jdepth, jlh, jlw = jme._static_node_tables(c, h, w, *ll, level,
                                                      key)
    filt, depth = tme._static_node_tables(c, h, w, *ll, level)
    np.testing.assert_array_equal(filt, jfilt)
    np.testing.assert_array_equal(depth, jdepth)
    rect = torch.as_tensor(tgeom.rect_table(level, *ll, wire))[
        torch.as_tensor(depth).long(), torch.as_tensor(filt).long()]
    node = torch.arange(c * h * w)
    np.testing.assert_array_equal(
        tme._local((node % (h * w)) // w, rect[:, 0:2]).numpy(), jlh)
    np.testing.assert_array_equal(
        tme._local(node % w, rect[:, 2:4]).numpy(), jlw)


@pytest.mark.parametrize("name", ["plan_supported", "_static_geometry",
                                  "bits_per_plane_from_maps_np",
                                  "cut_plane_np"])
def test_planning_numpy_copies_identical(name):
    def tree(fn):
        return ast.dump(ast.parse(inspect.getsource(fn)))

    assert tree(getattr(tplan, name)) == tree(getattr(jplan, name))


@pytest.mark.parametrize("pair", [
    (jdist.encode_manifest, tdist.encode_manifest),
    (jdist.load_manifest, tdist.load_manifest),
    (jdist.merge_manifests, tdist.merge_manifests),
    (jinterop._is_torch, tinterop._is_torch),
    (jinterop.as_numpy_image, tinterop.as_numpy_image),
], ids=lambda p: p[0].__name__)
def test_copied_functions_identical(pair):
    """The JAX-free functions the port copies (docstrings aside)."""
    def tree(fn):
        node = ast.parse(inspect.getsource(fn)).body[0]
        body = node.body
        if (isinstance(body[0], ast.Expr) and isinstance(body[0].value,
                                                         ast.Constant)):
            node.body = body[1:]
        return ast.dump(node)

    assert tree(pair[0]) == tree(pair[1])
