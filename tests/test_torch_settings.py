"""The port's Settings against the JAX package's: ``tests/test_config.py``'s
cases run against both, the environment gives equal fields, and the field
set is JAX's plus the port's ``device`` (``RAGFIN_DEVICE``)."""

import dataclasses
import os

import pytest

from ragfin_tpu.config import settings as j_settings
from ragfin_tpu_torch.config import settings as t_settings

PACKAGES = {"jax": j_settings, "torch": t_settings}
ENV = {
    "RAGFIN_MODEL": "gpt-3.5-turbo", "OPENAI_API_KEY": "o", "GROQ_API_KEY": "q",
    "RAGFIN_DATA_DIR": "some/data", "RAGFIN_TOP_K": "7", "RAGFIN_EMBED_BACKEND": "hashed",
    "RAGFIN_TOPK_METHOD": "fused", "RAGFIN_INDEX_DTYPE": "bfloat16", "RAGFIN_INDEX_TYPE": "ivf",
    "RAGFIN_IVF_NPROBE": "8", "RAGFIN_INTEGRITY_WEIGHT": "0.25", "RAGFIN_TIMEOUT_S": "12.5",
    "RAGFIN_BATCH_QUERIES": "0",
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    mod = PACKAGES[request.param]
    mod.get_config.cache_clear()
    yield mod
    mod.get_config.cache_clear()


def test_api_key_routing(pkg):
    s = pkg.Settings(gemini_api_key="g", openai_api_key="o", groq_api_key="q")
    assert s.get_api_key_for_model("gemini-2.0-flash") == "g"
    assert s.get_api_key_for_model("gpt-3.5-turbo") == "o"
    assert s.get_api_key_for_model("llama3.1:8b") == "q"
    assert s.get_api_key_for_model("fake") is None


def test_model_dependent_timeout(pkg):
    s = pkg.Settings(base_timeout_s=10.0)
    assert s.get_timeout_for_model("llama3.1:8b") == 20.0  # local llama 2x
    assert s.get_timeout_for_model("gemini-2.0-flash") == 10.0
    s2 = pkg.Settings(base_timeout_s=10.0, groq_api_key="k")
    assert s2.get_timeout_for_model("llama3.1:8b") == 10.0  # hosted


def test_validate_reports_issues(pkg):
    issues = pkg.Settings(default_model="nope").validate()
    assert any("unknown default_model" in i for i in issues)
    issues = pkg.Settings(default_model="gemini-2.0-flash").validate()
    assert any("no API key" in i for i in issues)
    assert pkg.Settings(default_model="fake").validate() == []


def test_switch_default_model(pkg, monkeypatch):
    monkeypatch.setenv("RAGFIN_MODEL", "fake")  # restored after the switch writes it
    s = pkg.switch_default_model("gemini-2.0-flash")
    assert s.default_model == "gemini-2.0-flash"
    assert pkg.get_config().default_model == "gemini-2.0-flash"


def test_dotenv_loader(pkg, tmp_path, monkeypatch):
    env_file = tmp_path / ".env"
    env_file.write_text("RAGFIN_TEST_KEY='hello'\n# comment\nBAD LINE\n")
    monkeypatch.delenv("RAGFIN_TEST_KEY", raising=False)
    pkg.load_dotenv(str(env_file))
    assert os.environ["RAGFIN_TEST_KEY"] == "hello"
    monkeypatch.delenv("RAGFIN_TEST_KEY")


def _fields(mod) -> dict:
    return {f.name: f for f in dataclasses.fields(mod.Settings)}


def test_fields_are_jax_fields_plus_device():
    j, t = _fields(j_settings), _fields(t_settings)
    assert set(t) - set(j) == {"device"}
    assert set(j) - set(t) == set()
    assert _fields(t_settings)["device"].default is None


def test_defaults_equal():
    j, t = dataclasses.asdict(j_settings.Settings()), dataclasses.asdict(t_settings.Settings())
    t.pop("device")
    assert j == t
    assert t["collection_name"] == "fin_chunks" and t["topk_method"] == "auto"
    assert t["base_timeout_s"] == 30.0


def test_environment_gives_equal_fields(monkeypatch):
    for key in list(os.environ):
        if key.startswith("RAGFIN_"):
            monkeypatch.delenv(key)
    for key, value in ENV.items():
        monkeypatch.setenv(key, value)
    j, t = dataclasses.asdict(j_settings._from_env()), dataclasses.asdict(t_settings._from_env())
    assert t.pop("device") is None
    assert j == t
    assert t["topk_method"] == "fused" and t["base_timeout_s"] == 12.5
    monkeypatch.setenv("RAGFIN_DEVICE", "cpu")
    assert t_settings._from_env().device == "cpu"
