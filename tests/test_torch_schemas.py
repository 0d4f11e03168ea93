"""The port's OpenAPI document and response shapes
(``wis_tpu_torch/server/schemas.py``, no pydantic) and its logging setup
(``wis_tpu_torch/utils/logging.py``) held against ``wis_tpu``'s: the
document JSON-equal at the default beam buckets and at others (the
``beam_size`` description prints them), the dataclasses' fields in the
pydantic models' order, and the same root and app logger levels for every
LOG_LEVEL.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

from wis_tpu.server import schemas as jax_schemas
from wis_tpu.settings import APISettings as JaxSettings
from wis_tpu_torch.server import schemas
from wis_tpu_torch.settings import APISettings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("settings", [
    {},
    {"beam_buckets": ["5", "1", "10"]},
    {"beam_buckets": ["2"], "name": "wis", "description": "d", "version": "9"},
])
def test_openapi_document_equals_wis_tpus(settings):
    want = jax_schemas.openapi_document(JaxSettings(**settings))
    got = schemas.openapi_document(APISettings(**settings))
    assert json.dumps(got) == json.dumps(want)
    assert len(got["paths"]) == 7


@pytest.mark.parametrize("name", ["Ping", "ASR", "WillowStats"])
def test_shapes_follow_the_pydantic_models(name):
    model, shape = getattr(jax_schemas, name), getattr(schemas, name)
    assert [f.name for f in dataclasses.fields(shape)] == list(model.model_fields)
    literal = {"Ping": schemas.PING_SCHEMA, "ASR": schemas.ASR_SCHEMA}.get(name)
    if literal is not None:
        assert json.dumps(literal) == json.dumps(model.model_json_schema())
    required = [n for n, f in model.model_fields.items() if f.is_required()]
    defaults = [f.name for f in dataclasses.fields(shape)
                if f.default is dataclasses.MISSING]
    assert defaults == required


def test_configure_logging_levels_equal():
    """For each LOG_LEVEL (and none, and an unknown one): the same root
    level and the same level on the app logger (``wis_tpu`` /
    ``wis_tpu_torch``), each set up in a clean root."""
    code = (
        "import json, logging, os\n"
        "from wis_tpu.utils.logging import configure_logging as jax_cfg\n"
        "from wis_tpu_torch.utils.logging import configure_logging as port_cfg\n"
        "out = []\n"
        "for level in (None, 'debug', 'info', 'warning', 'error', 'bogus'):\n"
        "    row = []\n"
        "    for cfg in (jax_cfg, port_cfg):\n"
        "        logging.root.handlers.clear()\n"
        "        os.environ.pop('LOG_LEVEL', None)\n"
        "        if level:\n"
        "            os.environ['LOG_LEVEL'] = level\n"
        "        lg = cfg()\n"
        "        row.append([logging.root.level, lg.level, lg.name])\n"
        "    row.append(port_cfg('warning').level)\n"
        "    out.append(row)\n"
        "print(json.dumps(out))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    rows = json.loads(res.stdout.strip().splitlines()[-1])
    for (jax_root, jax_app, jax_name), (root, app, name), explicit in rows:
        assert (root, app) == (jax_root, jax_app)
        assert (jax_name, name) == ("wis_tpu", "wis_tpu_torch")
        assert explicit == 30  # an explicit level wins over LOG_LEVEL
    assert [r[1][:2] for r in rows] == [[20, 20], [20, 10], [20, 20], [30, 30], [40, 40],
                                        [20, 20]]
