"""The port's edge-config checks (``wis_tpu_torch/utils/edgecheck.py``)
against ``wis_tpu/utils/edgecheck.py``: the same problem lists on the
repo's nginx configs, auth templates and compose files, and on every broken
case of ``tests/test_edge_config.py``; the same exceptions; the same
tables of known directives and contexts.
"""

import glob
import os

import pytest

import test_edge_config
from wis_tpu.utils import edgecheck as jax_edge
from wis_tpu_torch.utils import edgecheck as edge

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NGINX = os.path.join(REPO, "nginx")

#: test_edge_config's broken nginx snippets, read from its parametrization
BROKEN = next(m.args[1] for m in test_edge_config.test_nginx_parser_catches_breakage.pytestmark
              if m.name == "parametrize")


def _problems(mod, text, **kw):
    """validate(parse(text)) of ``mod``, or [str(error)] where parsing
    refuses the text (with the error's type name)."""
    try:
        return mod.validate(mod.parse(text), **kw)
    except mod.NginxConfigError as e:
        return [f"NginxConfigError: {e}"]


def test_tables_equal():
    assert edge.KNOWN_DIRECTIVES == jax_edge.KNOWN_DIRECTIVES
    assert edge.BLOCK_CONTEXTS == jax_edge.BLOCK_CONTEXTS
    assert edge.BLOCK_DIRECTIVES == jax_edge.BLOCK_DIRECTIVES
    assert edge.NginxConfigError is not jax_edge.NginxConfigError
    assert issubclass(edge.NginxConfigError, ValueError)


def test_repo_nginx_conf():
    path = os.path.join(NGINX, "nginx.conf")
    assert edge.check_nginx_conf(path) == jax_edge.check_nginx_conf(path) == []
    with open(path) as f:
        text = f.read()
    assert list(edge.tokenize(text)) == list(jax_edge.tokenize(text))
    flat = [(d.name, d.args, d.line) for top in edge.parse(text) for d in top.walk()]
    want = [(d.name, d.args, d.line) for top in jax_edge.parse(text) for d in top.walk()]
    assert flat == want and len(flat) > 20


@pytest.mark.parametrize("name,subs,context", [
    ("auth.conf.template", dict(API_KEY="k"), "http"),
    ("auth.conf.template", dict(API_KEY="sekrit-key-123"), "http"),
    ("auth-basic.conf.template", dict(AUTH_BASIC="off"), "server"),
    ("auth-basic.conf.template", dict(AUTH_BASIC='"Willow"'), "server"),
])
def test_auth_templates(name, subs, context):
    with open(os.path.join(NGINX, name)) as f:
        tpl = f.read()
    got = edge.render_auth_template(tpl, **subs)
    assert got == jax_edge.render_auth_template(tpl, **subs)
    assert _problems(edge, got, context=context) == _problems(jax_edge, got, context=context) == []


def test_unrendered_placeholder_raises_in_both():
    with open(os.path.join(NGINX, "auth.conf.template")) as f:
        tpl = f.read()
    errors = []
    for mod in (edge, jax_edge):
        with pytest.raises(mod.NginxConfigError) as e:
            mod.render_auth_template(tpl)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "unrendered" in errors[0]


@pytest.mark.parametrize("bad,msg", BROKEN)
def test_broken_snippets(bad, msg):
    got = _problems(edge, bad)
    assert got == _problems(jax_edge, bad)
    assert any(msg in p for p in got), got


@pytest.mark.parametrize("text,context", [
    ("http { map $a $b { default 0; x { y; } } }", ""),
    ("events { }", "http"),
    ("http { upstream { server a; } server { listen; } }", ""),
    ("http { server { location / { proxy_cache off; } } proxy_cache_path /c keys_zone=z:1m; }", ""),
    ("server { location / { proxy_pass http://nowhere; } }", "http"),
    ("http { 'quoted' \"x\\\"y\"; }", ""),
])
def test_more_snippets(text, context):
    assert _problems(edge, text, context=context) == _problems(jax_edge, text, context=context)


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "docker-compose*.yml"))))
def test_repo_compose_files(path):
    assert edge.check_compose(path, REPO) == jax_edge.check_compose(path, REPO) == []


def test_broken_compose(tmp_path):
    bad = tmp_path / "compose.yml"
    bad.write_text(
        """
services:
  wis:
    volumes: ["./nginx/missing.conf:/etc/nginx/nginx.conf:ro", "nocache:/var/c"]
    ports: ["abc:80"]
    depends_on: [ghost]
  odd: 3
  ok:
    image: x
    volumes: ["./models:/m", "/abs:/a"]
    ports: ["19000:19000", "53/udp"]
"""
    )
    got = edge.check_compose(str(bad), REPO)
    assert got == jax_edge.check_compose(str(bad), REPO)
    assert len(got) == 6
    empty = tmp_path / "empty.yml"
    empty.write_text("version: '3'\n")
    assert edge.check_compose(str(empty), REPO) == jax_edge.check_compose(str(empty), REPO)
