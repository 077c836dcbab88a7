"""Vorbis decoder conformance: host + device paths vs true libvorbis."""

import numpy as np
import pytest

from easyav1.container import WebMDemuxer, TrackType
from easyav1.audio.vorbis import VorbisDecoder
from easyav1.audio.vorbis.bitreader import BitReader, ilog, lookup1_values
from easyav1.audio.vorbis.codebook import assign_codewords
from easyav1.audio.vorbis.device import VorbisDeviceSynth

from fixtures import make_fixture, vorbis_oracle_decode, have_vorbis_oracle

TOL = 5e-6  # libvorbis float32 rounding differences only


def _stream_packets(**params):
    fx = make_fixture(frames=0, **params)
    d = WebMDemuxer(str(fx))
    at = d.tracks_of_type(TrackType.AUDIO)[0]
    pkts = []
    while (p := d.read_packet()) is not None:
        if p.track == at.number:
            pkts.extend(p.frames)
    return at.vorbis_headers(), pkts


needs_oracle = pytest.mark.skipif(not have_vorbis_oracle(),
                                  reason="reference minivorbis not mounted")


@needs_oracle
@pytest.mark.parametrize("params", [
    dict(audio_secs=2.0, channels=2),
    dict(audio_secs=1.0, channels=1),
    dict(audio_secs=1.0, channels=2, audio_rate=44100),
    dict(audio_secs=2.0, channels=2, audio_kind=1),  # transient-heavy
    dict(audio_secs=1.0, channels=2, vorbis_q=0.0),
    dict(audio_secs=1.0, channels=2, vorbis_q=0.9),
], ids=["stereo", "mono", "44k1", "clicks", "q0", "q9"])
def test_host_decode_matches_libvorbis(params):
    headers, pkts = _stream_packets(**params)
    golden = vorbis_oracle_decode(headers + pkts)
    dec = VorbisDecoder(headers)
    outs = [dec.decode_packet_host(pk) for pk in pkts]
    mine = np.concatenate(outs, axis=0)
    assert mine.shape == golden.shape
    assert np.abs(mine - golden).max() < TOL


@needs_oracle
def test_device_synth_matches_libvorbis():
    headers, pkts = _stream_packets(audio_secs=2.0, channels=2, audio_kind=1)
    golden = vorbis_oracle_decode(headers + pkts)
    dec = VorbisDecoder(headers)
    blocks = [b for b in (dec.decode_packet_symbols(pk) for pk in pkts)
              if b is not None]
    # transient fixture must actually exercise both block sizes
    ns = {b.n for b in blocks}
    assert len(ns) == 2, f"expected mixed block sizes, got {ns}"
    synth = VorbisDeviceSynth(dec.info.channels, dec.info.blocksize0,
                              dec.info.blocksize1,
                              tuple(blocks[0].coupling), chunk=32)
    mine = synth.process(blocks)
    assert mine.shape == golden.shape
    assert np.abs(mine - golden).max() < TOL


@needs_oracle
def test_device_chunk_boundaries_equal_host():
    """Chunked device synthesis must be independent of chunk size."""
    headers, pkts = _stream_packets(audio_secs=1.0, channels=2)
    dec = VorbisDecoder(headers)
    blocks = [b for b in (dec.decode_packet_symbols(pk) for pk in pkts)
              if b is not None]
    outs = {}
    for chunk in (7, 64):
        dec2 = VorbisDecoder(headers)
        synth = VorbisDeviceSynth(dec.info.channels, dec.info.blocksize0,
                                  dec.info.blocksize1,
                                  tuple(blocks[0].coupling), chunk=chunk)
        outs[chunk] = synth.process(blocks)
    assert np.array_equal(outs[7], outs[64])


def test_truncated_packets_do_not_crash():
    headers, pkts = _stream_packets(audio_secs=0.5, channels=2)
    dec = VorbisDecoder(headers)
    for pk in pkts[:20]:
        for cut in (0, 1, 2, 7, len(pk) // 2):
            dec.decode_packet_host(pk[:cut])


def test_reset_resynchronizes():
    """After reset (seek semantics), decode must restart cleanly: parity
    with vorbis_synthesis_restart (easyav1.c:3077)."""
    headers, pkts = _stream_packets(audio_secs=1.0, channels=2)
    dec = VorbisDecoder(headers)
    full = np.concatenate([dec.decode_packet_host(p) for p in pkts], axis=0)
    dec.reset()
    replay = np.concatenate([dec.decode_packet_host(p) for p in pkts], axis=0)
    assert np.array_equal(full, replay)


# ---------------------------------------------------------------------------
# Unit tests

def test_bitreader_lsb_first():
    br = BitReader(bytes([0b10110010, 0xFF]))
    assert br.read(1) == 0
    assert br.read(3) == 0b001
    assert br.read(4) == 0b1011
    assert br.read(8) == 0xFF


def test_ilog():
    assert [ilog(x) for x in (0, 1, 2, 3, 4, 7)] == [0, 1, 2, 2, 3, 3]


def test_lookup1_values():
    assert lookup1_values(16, 4) == 2
    assert lookup1_values(1, 1) == 1
    assert lookup1_values(625, 4) == 5
    assert lookup1_values(624, 4) == 4


def test_huffman_canonical_assignment():
    # Spec §3.2.1 worked example: lengths [2,4,4,4,4,2,3,3]
    codes = assign_codewords([2, 4, 4, 4, 4, 2, 3, 3])
    assert codes == [0b00, 0b0100, 0b0101, 0b0110, 0b0111, 0b10, 0b110, 0b111]


def test_huffman_unordered_lengths():
    # entries not sorted by length must still get prefix-free codes
    lengths = [3, 1, 4, 4, 3, 4, 4]  # kraft sum exactly 1
    codes = assign_codewords(lengths)
    seen = set()
    for c, l in zip(codes, lengths):
        bits = f"{c:0{l}b}"
        for p in seen:
            assert not bits.startswith(p) and not p.startswith(bits)
        seen.add(bits)
