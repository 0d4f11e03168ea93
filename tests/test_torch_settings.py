"""The port's settings loader (``wis_tpu_torch/settings.py``) held against
``wis_tpu.settings``: the same defaults, and the same values from the same
environment and ``.env`` file, without pydantic."""

import dataclasses
import sys
import types

import pytest

from wis_tpu import settings as jax_settings
from wis_tpu_torch import settings as port_settings

SHARED = [f.name for f in dataclasses.fields(port_settings.APISettings)]


def _assert_equal(port, ref):
    for name in SHARED:
        assert getattr(port, name) == getattr(ref, name), name
        assert type(getattr(port, name)) is type(getattr(ref, name)), name


def test_every_shared_default_equal():
    _assert_equal(port_settings.APISettings(), jax_settings.APISettings())
    # the fields the batcher, replicas, session and TTS settings read are present
    for name in ("batch_window_s", "batch_admit_s", "batch_admit_max_s", "replica_pool",
                 "xtts_speaker_dir", "tts_stream_chunk_size", "name", "description",
                 "version"):
        assert name in SHARED
    # the mesh axes (parallel/mesh.py), read by nothing in either package
    assert "mesh_replica_axis" in SHARED and "mesh_tensor_axis" in SHARED
    assert set(SHARED) <= set(jax_settings.APISettings.model_fields)


@pytest.fixture
def clean_env(monkeypatch, tmp_path):
    """No shared field in the environment, and an empty working directory."""
    import os

    for key in list(os.environ):
        if key.lower() in jax_settings.APISettings.model_fields:
            monkeypatch.delenv(key)
    monkeypatch.chdir(tmp_path)
    return monkeypatch


ENVIRONMENTS = {
    "bools": {"PRELOAD_ALL_MODELS": "yes", "support_chunking": "0",
              "Preload_Whisper_Model_Tiny": "off", "PRELOAD_WHISPER_MODEL_BASE": "T"},
    "optional_bool": {"SUPPORT_SV": "true"},
    "optional_bool_false": {"SUPPORT_SV": "nope"},
    "ints": {"BEAM_SIZE": "3", "MAX_DECODE_TOKENS": " 96 ", "HBM_BUDGET_BYTES": "85899345920"},
    "floats": {"BATCH_WINDOW_S": "0.01", "BATCH_ADMIT_S": "2e-2", "SV_THRESHOLD": "1"},
    "json_lists": {"BATCH_BUCKETS": '["1", "2", "8"]', "BEAM_BUCKETS": ' ["5"]'},
    "csv_lists": {"BATCH_BUCKETS": "1, 2,,4 ", "AUDIO_SECOND_BUCKETS": "8"},
    "strings": {"WHISPER_MODEL_DEFAULT": "large", "REPLICA_POOL": "off",
                "XTTS_SPEAKER_DIR": "/srv/voices", "NAME": "wis"},
    "int_kept_raw_zero_fraction": {"BEAM_SIZE": " 5.00 ", "WARMUP_ITERATIONS": "+2.0"},
    "serving_csv": {"CORS_ALLOWED_ORIGINS": "https://a.example, https://b.example",
                    "BASIC_AUTH_USER": "u", "BASIC_AUTH_PASS": "p:w", "DETECT_LANGUAGE": "on",
                    "RTC_PORT_START": "20000", "RTC_PORT_END": " 20010 ", "XTTS_QUANT": "none"},
    "serving_json": {"CORS_ALLOWED_ORIGINS": '["*"]', "basic_auth_user": ""},
    "mesh_axes": {"MESH_REPLICA_AXIS": "4", "mesh_tensor_axis": " 2 "},
}


@pytest.mark.parametrize("case", sorted(ENVIRONMENTS))
def test_environment_gives_the_same_values(clean_env, case):
    for key, value in ENVIRONMENTS[case].items():
        clean_env.setenv(key, value)
    _assert_equal(port_settings._settings_from_env(), jax_settings._settings_from_env())


@pytest.mark.parametrize("key,value", [("BEAM_SIZE", "lots"), ("BEAM_SIZE", "3.5"),
                                       ("BATCH_WINDOW_S", "soon"),
                                       ("BATCH_BUCKETS", '["1", '),
                                       ("MESH_TENSOR_AXIS", "two")])
def test_unparsable_value_refused_by_both(clean_env, key, value):
    """The JAX loader keeps a value it cannot coerce raw and its pydantic
    model refuses it; the port refuses it in the loader."""
    clean_env.setenv(key, value)
    with pytest.raises(ValueError):
        jax_settings._settings_from_env()
    with pytest.raises(ValueError, match=key.lower()):
        port_settings._settings_from_env()


def test_dotenv_file_under_the_environment(clean_env, tmp_path):
    (tmp_path / ".env").write_text(
        "# a comment\n"
        "\n"
        "BEAM_SIZE=2\n"
        "WHISPER_MODEL_DEFAULT='small'\n"
        'BATCH_ADMIT_MAX_S="0.5"\n'
        "SUPPORT_SV=false\n"
        "no equals sign here\n"
        "LONG_BEAM_SIZE = 5\n"
    )
    clean_env.setenv("BEAM_SIZE", "1")  # the process environment wins
    port, ref = port_settings._settings_from_env(), jax_settings._settings_from_env()
    _assert_equal(port, ref)
    assert (port.beam_size, port.whisper_model_default, port.batch_admit_max_s,
            port.support_sv, port.long_beam_size) == (1, "small", 0.5, False, 5)
    assert port_settings._load_dotenv() == jax_settings._load_dotenv()


def test_custom_settings_hook(clean_env):
    """A module named custom_settings with get_api_settings replaces the
    loader in both packages."""
    mine = port_settings.APISettings(beam_size=3)
    hook = types.ModuleType("custom_settings")
    hook.get_api_settings = lambda: mine
    clean_env.setitem(sys.modules, "custom_settings", hook)
    port_settings.get_api_settings.cache_clear()
    try:
        assert port_settings.get_api_settings() is mine
        assert port_settings.get_api_settings() is mine  # cached
    finally:
        port_settings.get_api_settings.cache_clear()
    # a custom_settings module without the function falls through to the
    # environment, as in wis_tpu
    clean_env.setitem(sys.modules, "custom_settings", types.ModuleType("custom_settings"))
    clean_env.setenv("BEAM_SIZE", "2")
    jax_settings.get_api_settings.cache_clear()
    try:
        port, ref = port_settings.get_api_settings(), jax_settings.get_api_settings()
        _assert_equal(port, ref)
        assert port.beam_size == 2
    finally:
        port_settings.get_api_settings.cache_clear()
        jax_settings.get_api_settings.cache_clear()
