"""The port's packet codec against the JAX reference: byte-identical wire
rows and bit-identical parsed fields, for the host numpy twins and for the
torch codec of the engine's wire path, on random widths."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packet as jpk
from repro_torch.core import packet as tpk

torch.set_num_threads(1)


def _fields(rng, b, f):
    mid = rng.integers(0, 65536, b).astype(np.int32)
    scale = rng.integers(0, 40, b).astype(np.int32)
    flags = rng.integers(0, 256, b).astype(np.int32)
    feats = rng.integers(-2 ** 31, 2 ** 31 - 1, (b, f)).astype(np.int32)
    return mid, scale, flags, feats


def test_constants_match():
    assert tpk.HEADER_BYTES == jpk.HEADER_BYTES == 7
    assert tpk.FEATURE_BYTES == jpk.FEATURE_BYTES == 4
    assert (tpk.FLAG_PADDED, tpk.FLAG_RESULT, tpk.FLAG_REFLEX) == (
        jpk.FLAG_PADDED, jpk.FLAG_RESULT, jpk.FLAG_REFLEX)
    for n in (0, 1, 16, 32):
        assert tpk.packet_nbytes(n) == jpk.packet_nbytes(n)


@pytest.mark.parametrize("f", [0, 1, 5, 12, 32])
def test_numpy_encode_and_header_match(f):
    rng = np.random.default_rng(f)
    mid, scale, flags, feats = _fields(rng, 97, f)
    fcnt = rng.integers(0, f + 1, 97)
    oc = rng.integers(0, 9, 97)
    np.testing.assert_array_equal(
        tpk.encode_packets_np(mid, scale, feats, flags=flags, output_cnt=oc,
                              feature_cnt=fcnt),
        jpk.encode_packets_np(mid, scale, feats, flags=flags, output_cnt=oc,
                              feature_cnt=fcnt))
    a = np.zeros((97, 9), np.uint8)
    b = np.zeros((97, 9), np.uint8)
    tpk.write_header_np(a, 7, 8, flags=3, output_cnt=2, feature_cnt=1)
    jpk.write_header_np(b, 7, 8, flags=3, output_cnt=2, feature_cnt=1)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("f,max_features", [(4, 4), (8, 12), (12, 8), (0, 3)])
def test_numpy_parse_matches(f, max_features):
    rng = np.random.default_rng(10 * f + max_features)
    mid, scale, flags, feats = _fields(rng, 131, f)
    fcnt = rng.integers(0, 256, 131)  # includes counts beyond the block
    rows = jpk.encode_packets_np(mid, scale, feats, flags=flags,
                                 feature_cnt=fcnt)
    for got, want in zip(tpk.parse_packets_np(rows, max_features),
                         jpk.parse_packets_np(rows, max_features)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_out", [1, 4, 16])
def test_numpy_emit_matches(n_out):
    rng = np.random.default_rng(n_out)
    mid, _, flags, outs = _fields(rng, 64, n_out)
    np.testing.assert_array_equal(
        tpk.emit_results_np(mid, flags, outs, 8),
        jpk.emit_results_np(mid, flags, outs, 8))


@pytest.mark.parametrize("f,max_features", [(4, 4), (8, 12), (12, 8)])
def test_torch_wire_codec_matches(f, max_features):
    """parse_packets → emit_results on a uint8 tensor equals the jax device
    codec on the same rows, field by field and byte by byte."""
    rng = np.random.default_rng(100 + f)
    mid, scale, flags, feats = _fields(rng, 77, f)
    rows = jpk.encode_packets_np(mid, scale, feats, flags=flags,
                                 feature_cnt=rng.integers(0, f + 2, 77))
    tp = tpk.parse_packets(torch.as_tensor(rows), max_features)
    jp = jpk.parse_packets(jnp.asarray(rows), max_features)
    for name in ("model_id", "feature_cnt", "output_cnt", "scale", "flags",
                 "features_q"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    outs = rng.integers(-2 ** 31, 2 ** 31 - 1, (77, 6)).astype(np.int32)
    np.testing.assert_array_equal(
        tpk.emit_results(tp, torch.as_tensor(outs), 11).numpy(),
        np.asarray(jpk.emit_results(jp, jnp.asarray(outs), 11)))
    np.testing.assert_array_equal(
        tpk.encode_packets(torch.as_tensor(mid), 9,
                           torch.as_tensor(feats)).numpy(),
        np.asarray(jpk.encode_packets(jnp.asarray(mid), jnp.int32(9),
                                      jnp.asarray(feats))))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packet_stream_byte_identical_to_reference(seed):
    """``packet_stream`` draws in the reference's order (features, Model
    IDs, codes) and builds the rows with the numpy codec: three batches of
    each stream equal byte for byte, with their features and Model IDs."""
    from repro.data.packets import PacketGenConfig as JConfig
    from repro.data.packets import packet_stream as jstream
    from repro_torch.data.packets import PacketGenConfig, packet_stream
    kw = dict(n_features=16, batch=96, frac_bits=7 + seed,
              model_ids=(1, 2, 300), seed=seed)
    assert PacketGenConfig() == PacketGenConfig(8, 1024, 8, (1,), 0)
    got, want = packet_stream(PacketGenConfig(**kw)), jstream(JConfig(**kw))
    for _ in range(3):
        g, w = next(got), next(want)
        assert g["packets"].dtype == np.uint8
        np.testing.assert_array_equal(g["packets"], np.asarray(w["packets"]))
        np.testing.assert_array_equal(g["features"], w["features"])
        np.testing.assert_array_equal(g["model_id"], w["model_id"])
