"""The port's audio codecs and ingest (``wis_tpu_torch/audio/{codecs,
ingest}.py``) held against ``wis_tpu.audio``: the same native sources and
flags build both libraries, so every decode, mixdown and resample is
bit-equal; the Python fallbacks are held against the JAX package's
fallbacks; malformed streams end in the same exception classes."""

import io
import pathlib
import shutil
import struct
import wave

import numpy as np
import pytest

from fixture_codecs import (
    encode_mp3,
    encode_ogg_opus,
    encode_ogg_vorbis,
    lame_available,
    ogg_pages,
    opus_available,
    vorbis_available,
)
from test_flac_security import BitWriter, _frame_header, _streaminfo
from wis_tpu.audio import codecs as jax_codecs
from wis_tpu.audio import ingest as jax_ingest
from wis_tpu_torch.audio import codecs, ingest

REPO = pathlib.Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.skipif(
    not (jax_codecs.native_available() and codecs.native_available()),
    reason="native wisaudio library unavailable",
)


def _tone(n, sr, f=440.0, amp=0.5, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    return (amp * np.sin(2 * np.pi * f * t) + 0.01 * rng.standard_normal(n)).astype(np.float32)


def _wav(fmt, bits, data, sr=16000, channels=1):
    byte_rate = sr * channels * bits // 8
    block = channels * bits // 8
    return b"".join([
        b"RIFF", struct.pack("<I", 36 + len(data)), b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 16, fmt, channels, sr, byte_rate, block, bits),
        b"data", struct.pack("<I", len(data)), data,
    ])


def _wav16(pcm, sr, channels=1):
    ints = (np.clip(pcm, -1, 1) * 32767).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(ints.tobytes())
    return buf.getvalue()


def _pcm_ints(bits, n, seed):
    rng = np.random.default_rng(seed)
    lim = 2 ** (bits - 1)
    return rng.integers(-lim, lim, n, dtype=np.int64)


def _wav_of_bits(bits, channels, seed):
    """PCM WAV at 8 (unsigned), 16, 24 and 32 bits."""
    v = _pcm_ints(bits, 1000 * channels, seed)
    if bits == 8:
        raw = (v + 128).astype(np.uint8).tobytes()
    elif bits == 24:
        raw = b"".join(int(x & 0xFFFFFF).to_bytes(3, "little") for x in v)
    else:
        raw = v.astype(f"<i{bits // 8}").tobytes()
    return _wav(1, bits, raw, sr=22050, channels=channels)


def _flac(pcm_i16: np.ndarray, sr=16000, block=4096) -> bytes:
    """A FLAC stream of 16-bit (frames, channels) samples: verbatim
    subframes, a constant subframe for silent blocks, and left-side stereo
    for two channels (the native decoder does not check the CRCs)."""
    n, nch = pcm_i16.shape
    out = bytearray(_streaminfo(channels=nch, sample_rate=sr, total_samples=n))
    for fi, start in enumerate(range(0, n, block)):
        blk = pcm_i16[start:start + block].astype(np.int64)
        w = BitWriter()
        w.write(0x3FFE, 14)
        w.write(0, 2)
        full = blk.shape[0] == 4096
        w.write(12 if full else 7, 4)
        w.write(0, 4)  # sample rate from STREAMINFO
        w.write(8 if nch == 2 else nch - 1, 4)
        w.write(4, 3)  # 16 bits
        w.write(0, 1)
        w.write(fi, 8)  # UTF-8 frame number < 128
        if not full:
            w.write(blk.shape[0] - 1, 16)
        w.write(0, 8)  # CRC-8
        chans = [blk[:, 0], blk[:, 0] - blk[:, 1]] if nch == 2 else [blk[:, c] for c in range(nch)]
        for c, x in enumerate(chans):
            bps = 17 if (nch == 2 and c == 1) else 16
            w.write(0, 1)
            if not x.any():
                w.write(0, 6)  # CONSTANT
                w.write(0, 1)
                w.write(0, bps)
                continue
            w.write(1, 6)  # VERBATIM
            w.write(0, 1)
            for s in x:
                w.write(int(s) & ((1 << bps) - 1), bps)
        body = w.bytes()  # pads to a byte
        out += body + b"\x00\x00"  # CRC-16
    return bytes(out)


def _same(got, want):
    """Both results of one call equal: arrays bit-equal, or the same
    exception class name."""
    if isinstance(want, BaseException):
        assert type(got).__name__ == type(want).__name__, (got, want)
        return
    assert not isinstance(got, BaseException), got
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want, equal_nan=True)
    else:
        assert got == want


def _both(fn_name, *args, module="codecs", **kw):
    pair = (codecs, jax_codecs) if module == "codecs" else (ingest, jax_ingest)
    out = []
    for mod in pair:
        try:
            out.append(getattr(mod, fn_name)(*args, **kw))
        except Exception as e:  # noqa: BLE001 — the class is what is compared
            out.append(e)
    _same(*out)
    return out[0]


# --------------------------------------------------------------------------- #
def test_library_built_under_build_and_native_untouched(tmp_path, monkeypatch):
    """The port builds its own library with g++ under build/ and never
    writes the JAX package's native/libwisaudio.so."""
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    native = REPO / "native" / "libwisaudio.so"
    before = native.stat() if native.exists() else None
    default = codecs.library_path()
    assert default.parent.parent == REPO / "build" / "wis_tpu_torch" / "wisaudio"
    assert default.is_file()  # the module's first use built it
    monkeypatch.setattr(codecs, "BUILD_ROOT", tmp_path / "wisaudio")
    path = codecs.library_path()
    assert path.name == default.name and path.parent.name == default.parent.name
    assert codecs._build_library(path) and path.is_file()
    assert sorted(p.name for p in path.parent.iterdir()) == [".lock", "libwisaudio.so"]
    after = native.stat() if native.exists() else None
    assert (before is None) == (after is None)
    if before is not None:
        assert (before.st_mtime_ns, before.st_size, before.st_ino) == (
            after.st_mtime_ns, after.st_size, after.st_ino)


@pytest.mark.parametrize("bits", [8, 16, 24, 32])
@pytest.mark.parametrize("channels", [1, 2])
def test_decode_wav_bits(bits, channels):
    pcm, nch, sr = _both("decode_wav", _wav_of_bits(bits, channels, seed=bits + channels))
    assert (pcm.shape, nch, sr) == ((1000, channels), channels, 22050)


def test_decode_wav_float_and_g711():
    tone = _tone(4000, 16000).astype("<f4")
    _both("decode_wav", _wav(3, 32, tone.tobytes()))
    _both("decode_wav", _wav(7, 8, bytes(range(256))))  # µ-law
    _both("decode_wav", _wav(6, 8, bytes(range(256))))  # A-law


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_pcm_to_float(bits):
    raw = _pcm_ints(bits, 777, seed=bits).astype(f"<i{bits // 8}").tobytes()
    _both("pcm_to_float", raw, bits)


def test_mix_to_mono():
    rng = np.random.default_rng(3)
    for ch in (1, 2, 3, 6):
        _both("mix_to_mono", rng.standard_normal((501, ch)).astype(np.float32))
    _both("mix_to_mono", rng.standard_normal(64).astype(np.float32))


@pytest.mark.parametrize("sr_in,sr_out", [(48000, 16000), (44100, 16000), (8000, 16000),
                                          (16000, 24000), (22050, 16000), (16000, 16000)])
def test_resample_both_ways(sr_in, sr_out):
    out = _both("resample", _tone(sr_in // 2, sr_in), sr_in, sr_out)
    assert abs(out.shape[0] - sr_out // 2) <= 1


def test_python_fallbacks_equal(monkeypatch):
    """With no native library on either side, WAV, PCM, mixdown and
    resample take the Python fallbacks (the port's resampler is
    audio/resample.py) and agree; FLAC is refused by both."""
    monkeypatch.setattr(codecs, "_load_library", lambda: None)
    monkeypatch.setattr(jax_codecs, "_load_library", lambda: None)
    assert not codecs.native_available()
    for bits in (8, 16, 32):
        _both("decode_wav", _wav_of_bits(bits, 2, seed=bits))
        _both("pcm_to_float", _pcm_ints(bits, 100, bits).astype(f"<i{bits // 8}").tobytes(), bits)
    _both("decode_wav", _wav_of_bits(24, 1, seed=1))  # unsupported width: CodecError
    _both("pcm_to_float", b"\x00" * 6, 24)
    _both("mix_to_mono", np.random.default_rng(0).standard_normal((300, 2)).astype(np.float32))
    for sr_in, sr_out in ((48000, 16000), (8000, 16000), (44100, 16000)):
        _both("resample", _tone(sr_in // 4, sr_in), sr_in, sr_out)
    _both("decode_flac", _flac(np.zeros((10, 1), np.int16)))
    _both("load_audio", _wav16(_tone(4410, 44100), 44100), module="ingest")


def test_sniff_format():
    for head in (b"fLaC....", b"RIFF1234WAVEfmt ", b"RIFF1234AVI ", b"ID3\x04...",
                 b"\xff\xfb\x90\x00", b"\xff\xf3..", b"\xff\xf2..", b"OggS....", b"\x00\x01",
                 b"", b"fLa", b"RIFF"):
        _both("sniff_format", head, module="ingest")


def test_load_audio_wav_stereo_44k():
    left, right = _tone(44100, 44100, 440.0), _tone(44100, 44100, 880.0, seed=1)
    inter = np.stack([left, right], axis=1).reshape(-1)
    audio = _both("load_audio", _wav16(inter, 44100, channels=2), module="ingest")
    assert audio.dtype == np.float32 and abs(audio.shape[0] - 16000) <= 1


@pytest.mark.parametrize("sr,bits,channels", [(16000, 16, 1), (48000, 16, 2), (16000, 8, 1),
                                              (8000, 32, 1)])
def test_load_audio_raw_pcm(sr, bits, channels):
    raw = _pcm_ints(bits, sr // 4 * channels, seed=sr).astype(f"<i{bits // 8}").tobytes()
    audio = _both("load_audio", raw, codec="pcm", sample_rate=sr, bits=bits,
                  channels=channels, module="ingest")
    assert abs(audio.shape[0] - 4000) <= 1
    _both("load_audio", raw, codec="PCM", sample_rate=sr, module="ingest")  # missing params


@pytest.mark.parametrize("channels", [1, 2])
def test_load_audio_flac(channels):
    rng = np.random.default_rng(channels)
    pcm = rng.integers(-20000, 20000, (9000, channels)).astype(np.int16)
    pcm[4096:8192] = 0  # a constant block
    data = _flac(pcm)
    raw, nch, sr = _both("decode_flac", data)
    assert (raw.shape, nch, sr) == ((9000, channels), channels, 16000)
    np.testing.assert_array_equal(raw, pcm / 32768.0)
    _both("load_audio", data, module="ingest")


@pytest.mark.skipif(not lame_available(), reason="lame not present")
def test_load_audio_mp3():
    data = encode_mp3(_tone(8000, 16000))
    audio = _both("load_audio", data, module="ingest")
    assert audio.shape[0] > 0
    _both("decode_mp3", data)


@pytest.mark.skipif(not (opus_available() and vorbis_available()),
                    reason="libopus or libvorbis not present")
def test_load_audio_ogg():
    for data in (encode_ogg_opus(_tone(8000, 16000)), encode_ogg_vorbis(_tone(8000, 16000))):
        audio = _both("load_audio", data, module="ingest")
        assert audio.shape[0] > 0


def test_wav_export_and_stream_header():
    tone = _tone(1000, 16000, amp=1.5)  # clipped
    data = _both("pcm_to_wav_bytes", tone, module="ingest")
    _both("pcm_to_wav_bytes", tone, bits=24, module="ingest")  # IngestError
    _both("decode_wav", data)
    for kw in ({}, dict(sr=24000), dict(sr=48000, bits=32, channels=2)):
        _both("wav_stream_header", module="ingest", **kw)
    assert _both("duration_ms", np.zeros(12345), module="ingest") == 771


# --------------------------------------------------------------------------- #
# Malformed streams (tests/test_ingest_security.py, test_flac_security.py)
# --------------------------------------------------------------------------- #
def _mutations(valid: bytes, seed: int, n: int = 40):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        buf = bytearray(valid)
        kind = rng.integers(0, 3)
        if kind == 0:
            buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
        elif kind == 1:
            buf = buf[: int(rng.integers(0, len(valid)))]
        else:
            pos = int(rng.integers(0, max(1, len(buf) - 16)))
            buf[pos:pos + 16] = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        yield bytes(buf)


def test_mutated_streams_end_alike():
    streams = [_wav16(_tone(6400, 16000), 16000), _flac(_pcm_ints(16, 6400, 9)
                                                         .astype(np.int16).reshape(-1, 1))]
    if lame_available():
        streams.append(encode_mp3(_tone(6400, 16000)))
    if opus_available():
        streams.append(encode_ogg_opus(_tone(6400, 16000)))
    if vorbis_available():
        streams.append(encode_ogg_vorbis(_tone(6400, 16000)))
    for i, valid in enumerate(streams):
        for data in _mutations(valid, seed=i):
            _both("load_audio", data, module="ingest")


def test_crafted_ogg_and_codec_mismatch():
    rng = np.random.default_rng(5)
    packets = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (7, 300, 5000)]
    _both("load_audio", ogg_pages(packets), module="ingest")
    for n in (4, 26, 27, 64, 1024):
        _both("load_audio", b"OggS" + rng.integers(0, 256, n, dtype=np.uint8).tobytes(),
              module="ingest")
    noise = rng.integers(0, 256, 2048, dtype=np.uint8).tobytes()
    for codec in ("wav", "flac", "mp3", "ogg", "aac"):
        _both("load_audio", noise, codec=codec, module="ingest")
        _both("load_audio", b"", codec=codec, module="ingest")


def test_wav_header_lies():
    def wav(fmt=1, bits=16, data_len=None, payload=b"\x00" * 64, channels=1, sr=16000,
            fmt_chunk_len=16):
        data_len = len(payload) if data_len is None else data_len
        return b"".join([
            b"RIFF", struct.pack("<I", 36 + len(payload)), b"WAVE",
            b"fmt ", struct.pack("<IHHIIHH", fmt_chunk_len, fmt, channels, sr,
                                 (sr * channels * bits // 8) & 0xFFFFFFFF,
                                 (channels * bits // 8) & 0xFFFF, bits & 0xFFFF),
            b"data", struct.pack("<I", data_len), payload,
        ])

    cases = [wav(data_len=1 << 30), wav(channels=0), wav(channels=65535), wav(sr=0),
             wav(sr=0x7FFFFFFF), wav(fmt=0xDEAD), wav(fmt_chunk_len=4),
             wav(fmt_chunk_len=1 << 20)] + [wav(bits=b) for b in (0, 1, 7, 12, 64, 255)]
    for data in cases:
        _both("load_audio", data, module="ingest")
        _both("decode_wav", data)


def test_crafted_flac_streams():
    # LPC order above the partition length
    w = BitWriter()
    _frame_header(w)
    w.write(0, 1)
    w.write(63, 6)
    w.write(0, 1)
    for _ in range(32):
        w.write(0, 16)
    w.write(0, 4)
    w.write(0, 5)
    for _ in range(32):
        w.write(0, 1)
    w.write(0, 2)
    w.write(12, 4)
    w.write(0x0F, 4)
    w.write(0, 5)
    lpc = _streaminfo() + w.bytes()
    # a side-stereo frame on a mono stream
    w = BitWriter()
    _frame_header(w, ch_code=8)
    side = _streaminfo(channels=1) + w.bytes()
    huge = _streaminfo(channels=8, total_samples=(1 << 36) - 1)
    for data in (lpc, side, huge, _streaminfo(bps=4), b"fLaC", b"fLaC\x00\x00\x00"):
        _both("decode_flac", data)
        _both("load_audio", data, module="ingest")
