"""The port's launcher and server surface held against the JAX package's:
the parser's served flags (dest, type, default, nargs, const, choices),
`.kcpps` round trips, `--nomodel`, `--ignoremissing`, `--smartcontext` routing,
`--benchmark`, the chat adapter and `--preloadstory`, and the new routes'
status, content type and JSON body for the same settings (the profiler's
trace contents excepted). CPU, the committed Q4_K_M fixture."""
import argparse
import json
import os

import pytest
import torch

from koboldcpp_tpu import cli as jcli
from koboldcpp_tpu.server import app as japp
from koboldcpp_tpu_torch import cli
from koboldcpp_tpu_torch.server import app as tapp

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)

pytest_plugins = ("aiohttp.pytest_plugin",)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures", "refgguf", "tiny-q4_k_m.gguf")

SERVED = ["--model", "--lora", "--loramult", "--port", "--host",
          "--password", "--multiuser", "--contextsize", "--maxrequestsize",
          "--quiet", "--debugmode", "--config", "--chatcompletionsadapter",
          "--preloadstory", "--benchmark", "--prompt", "--promptlimit",
          "--defaultgenamt", "--quantkv", "--flashattention",
          "--nocontextshift", "--noshift", "--smartcontext",
          "--nofastforward", "--ropeconfig", "--paged", "--pagesize",
          "--ssl", "--nocertify", "--onready", "--launch", "--nomodel",
          "--ignoremissing", "--mmproj", "--whispermodel", "--sdmodel",
          "--sdtaesd", "--sdvaeauto", "--sdvae", "--sdlora", "--sdloramult",
          "--sdclamped", *cli.COMPAT_FLAGS,
          # the horde worker, the tunnel, parallel and multi-host serving
          # and the launcher switch
          "--hordekey", "--hordeworkername", "--hordemodelname",
          "--hordemaxctx", "--hordegenlen", "--remotetunnel", "--mesh",
          "--pipeline", "--seqparallel", "--coordinator", "--numprocesses",
          "--processid", "--skiplauncher"]


def _actions(parser):
    return {o: a for a in parser._actions for o in a.option_strings}


@pytest.mark.parametrize("flag", SERVED)
def test_served_flag_matches_the_jax_parser(flag):
    got = _actions(cli.build_parser())[flag]
    want = _actions(jcli.build_parser())[flag]
    for attr in ("dest", "type", "default", "nargs", "const", "choices"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert type(got) is type(want)


def test_positionals_match_the_jax_parser():
    for dest in ("model_param", "port_param"):
        got = [a for a in cli.build_parser()._actions if a.dest == dest][0]
        want = [a for a in jcli.build_parser()._actions if a.dest == dest][0]
        assert (got.nargs, got.default) == (want.nargs, want.default)


def test_kcpps_round_trip(tmp_path):
    args = cli.build_parser().parse_args(
        [FIX, "--contextsize", "512", "--lora", "a.gguf", "b.gguf",
         "--ropeconfig", "0.5", "20000", "--smartcontext", "--usecpu"])
    path = str(tmp_path / "cfg.kcpps")
    cli.save_kcpps(path, args)
    data = json.load(open(path))
    assert "model_param" not in data and "config" not in data
    fresh = cli.load_kcpps(path, cli.build_parser().parse_args([]))
    for k, v in data.items():
        got = getattr(fresh, k)
        assert (list(got) if isinstance(got, tuple) else got) == v, k
    # the JAX package writes and reads the same keys for its flags
    jargs = jcli.build_parser().parse_args([])
    jcli.load_kcpps(path, jargs)
    assert jargs.contextsize == 512 and jargs.lora == ["a.gguf", "b.gguf"]


def test_kcpps_as_the_model_argument(tmp_path, capsys):
    path = str(tmp_path / "run.kcpps")
    with open(path, "w") as f:
        json.dump({"model": FIX, "device": "cpu", "contextsize": 256,
                   "prompt": "Once upon", "promptlimit": 3}, f)
    assert cli.main([path]) == 0
    out = capsys.readouterr().out
    assert f"Loading model: {FIX}" in out and "on cpu" in out


class _Served(Exception):
    pass


def _serve(monkeypatch, argv):
    """Run the port's main up to run_server; returns (engine, settings,
    run_server's keyword arguments)."""
    seen = {}

    def fake(engine, **kw):
        seen.update(engine=engine, **kw)
        raise _Served

    monkeypatch.setattr(tapp, "run_server", fake)
    with pytest.raises(_Served):
        cli.main(argv)
    return seen["engine"], seen["settings"], seen


def _jax_serve(monkeypatch, argv):
    seen = {}

    def fake(engine, **kw):
        seen.update(engine=engine, **kw)
        raise _Served

    import koboldcpp_tpu.utils.compile_cache as jcc

    monkeypatch.setattr(japp, "run_server", fake)
    monkeypatch.setattr(jcc, "enable_compile_cache", lambda: None)
    with pytest.raises(_Served):
        jcli.main(argv)
    return seen["engine"], seen["settings"], seen


async def test_nomodel_serves_an_inactive_shell(monkeypatch, aiohttp_client):
    engine, settings, kw = _serve(monkeypatch, ["--nomodel", "--quiet"])
    jengine, jsettings, _ = _jax_serve(monkeypatch, ["--nomodel", "--quiet"])
    assert isinstance(engine, cli.NullEngine)
    assert (settings.model_name, settings.quiet) == \
        (jsettings.model_name, jsettings.quiet) == ("inactive", True)
    assert kw["ssl_pair"] is None and kw["onready"] == "" and not kw["launch"]
    client = await aiohttp_client(tapp.make_app(engine, settings))
    jclient = await aiohttp_client(japp.make_app(jengine, jsettings))
    for path in ("/api/v1/model", "/api/extra/true_max_context_length"):
        r, jr = await client.get(path), await jclient.get(path)
        assert r.status == jr.status == 200
        assert await r.json() == await jr.json()
    body = {"prompt": "hi", "max_length": 4}
    r = await client.post("/api/v1/generate", json=body)
    jr = await jclient.post("/api/v1/generate", json=body)
    assert r.status == jr.status == 200
    assert await r.json() == await jr.json() == {"results": [
        {"text": "", "finish_reason": "length"}]}


def test_ignoremissing_skips_a_missing_lora(tmp_path, capsys):
    missing = str(tmp_path / "nope.gguf")
    argv = [FIX, "--device", "cpu", "--contextsize", "256", "--prompt",
            "Once", "--promptlimit", "2", "--lora", missing]
    with pytest.raises(OSError):
        cli.main(argv)
    assert cli.main(argv + ["--ignoremissing"]) == 0
    assert f"--ignoremissing: skipping missing lora {missing}" in \
        capsys.readouterr().out


@pytest.mark.parametrize("multiuser", ["1", "4"])
def test_smartcontext_is_served_single_stream(multiuser, monkeypatch,
                                              capsys):
    """--smartcontext: the single-sequence engine with smart context on
    and shift off, --multiuser > 1 routed to it with the JAX launcher's
    note."""
    from koboldcpp_tpu_torch.engine import Engine

    engine, settings, _ = _serve(monkeypatch, [
        FIX, "--device", "cpu", "--contextsize", "256", "--smartcontext",
        "--multiuser", multiuser])
    assert type(engine) is Engine
    assert engine.use_smartcontext and not engine.use_contextshift
    assert settings.multiuser == int(multiuser)
    out = capsys.readouterr().out
    assert ("smartcontext); serving with the single-sequence engine" in out) \
        == (multiuser != "1")


def test_noshift_reaches_both_engines(monkeypatch):
    from koboldcpp_tpu_torch.engine.batch_engine import BatchedEngine

    engine, _, _ = _serve(monkeypatch, [FIX, "--device", "cpu", "--noshift",
                                        "--contextsize", "256"])
    assert not engine.use_contextshift
    engine, _, _ = _serve(monkeypatch, [FIX, "--device", "cpu",
                                        "--nocontextshift", "--multiuser",
                                        "2", "--contextsize", "256"])
    try:
        assert isinstance(engine, BatchedEngine)
        assert not engine.use_contextshift
    finally:
        engine.shutdown()


def test_benchmark_prints_and_writes_its_csv(tmp_path, capsys):
    csv_path = str(tmp_path / "bench.csv")
    assert cli.main([FIX, "--device", "cpu", "--contextsize", "512",
                     "--benchmark", csv_path]) == 0
    out = capsys.readouterr().out
    assert "ProcessingSpeed:" in out and "GenerationSpeed:" in out
    rows = open(csv_path).read().splitlines()
    assert rows[0].startswith("Timestamp,Backend,Layers,Model,MaxCtx")
    assert rows[1].split(",")[1:5] == ["cuda", "all", "model", "512"]


@pytest.mark.parametrize("adapter", ["auto", "Alpaca", "file"])
def test_chat_adapter_and_preloaded_story_match_jax(adapter, tmp_path,
                                                    monkeypatch):
    story = str(tmp_path / "story.json")
    with open(story, "w") as f:
        json.dump({"prompt": "Once", "memory": "m"}, f)
    if adapter == "file":
        adapter = str(tmp_path / "adapter.json")
        with open(adapter, "w") as f:
            json.dump({"user_start": "U:", "assistant_start": "A:"}, f)
    argv = [FIX, "--contextsize", "256", "--chatcompletionsadapter",
            adapter, "--preloadstory", story, "--password", "pw"]
    _, settings, _ = _serve(monkeypatch, argv + ["--device", "cpu"])
    _, jsettings, _ = _jax_serve(monkeypatch, argv)
    for k in ("chat_adapter", "preloaded_story", "password", "model_name",
              "quiet", "multiuser"):
        assert getattr(settings, k) == getattr(jsettings, k), k


def test_ssl_onready_launch_reach_run_server(monkeypatch, tmp_path):
    _, _, kw = _serve(monkeypatch, [
        FIX, "--device", "cpu", "--contextsize", "256", "--ssl", "c.pem",
        "k.pem", "--onready", "echo hi", "--launch", "--port", "5099"])
    assert kw["ssl_pair"] == ["c.pem", "k.pem"] and kw["onready"] == \
        "echo hi" and kw["launch"] and kw["port"] == 5099


def test_usecpu_runs_on_the_cpu(capsys):
    assert cli.main([FIX, "--usecpu", "--contextsize", "256", "--prompt",
                     "Once", "--promptlimit", "2"]) == 0
    assert "on cpu" in capsys.readouterr().out


def test_compat_flags_are_accepted():
    args = cli.build_parser().parse_args(
        [FIX, "--usecublas", "normal", "--gpulayers", "99", "--threads",
         "8", "--highpriority", "--maxrequestsize", "64", "--debugmode", "1",
         "--defaultgenamt", "256", "--nofastforward"])
    assert args.usecublas == "normal" and args.highpriority is True
    assert isinstance(args, argparse.Namespace)


# ---------------------------------------------------------------------------
# the new routes against the JAX app's
# ---------------------------------------------------------------------------

STORY = {"prompt": "It was a dark night", "memory": "A ghost story."}
ROUTES = [("GET", "/"), ("GET", "/noscript"), ("GET", "/v1"),
          ("GET", "/api"), ("GET", "/docs"),
          ("GET", "/api/extra/preloadstory"),
          ("GET", "/api/v1/config/soft_prompt"),
          ("GET", "/api/v1/config/soft_prompts_list"),
          ("GET", "/api/tags"), ("OPTIONS", "/api/tags")]


@pytest.fixture
async def clients(aiohttp_client):
    kw = dict(model_name="test/tiny-q4_k_m", preloaded_story=STORY,
              chat_adapter="Alpaca", quiet=True)
    eng = cli.NullEngine(256)
    jeng = jcli.NullEngine(256)
    return (await aiohttp_client(tapp.make_app(
                eng, tapp.ServerSettings(**kw))),
            await aiohttp_client(japp.make_app(
                jeng, japp.ServerSettings(**kw))))


@pytest.mark.parametrize("method,path", ROUTES)
async def test_route_matches_the_jax_app(method, path, clients):
    client, jclient = clients
    r = await client.request(method, path)
    jr = await jclient.request(method, path)
    assert r.status == jr.status == 200
    assert r.content_type == jr.content_type
    assert r.headers.get("Access-Control-Allow-Origin") == \
        jr.headers.get("Access-Control-Allow-Origin") == "*"
    if r.content_type == "application/json":
        assert await r.json() == await jr.json()
    else:
        assert await r.text() == await jr.text()


async def test_noscript_post_matches_the_jax_app(clients):
    client, jclient = clients
    r = await client.post("/noscript", data={"prompt": "Hello"})
    jr = await jclient.post("/noscript", data={"prompt": "Hello"})
    assert r.status == jr.status == 200
    assert r.content_type == jr.content_type == "text/html"
    assert await r.text() == await jr.text()


async def test_lite_page_is_the_jax_packages(clients):
    client, _ = clients
    page = await (await client.get("/")).text()
    with open(os.path.join(ROOT, "koboldcpp_tpu", "server", "static",
                           "lite.html"), encoding="utf-8") as f:
        assert page == f.read()


async def test_profiler_routes_match_the_jax_app(clients, tmp_path):
    """start / start again (409) / stop / stop again (409): the same status
    and JSON keys as the JAX app; the port's trace is one Chrome trace."""
    client, jclient = clients
    for c, sub in ((client, "port"), (jclient, "jax")):
        d = str(tmp_path / sub)
        r = await c.post("/api/extra/profiler/start", json={"dir": d})
        assert r.status == 200 and await r.json() == {"success": True,
                                                       "dir": d}
        r = await c.post("/api/extra/profiler/start", json={"dir": d})
        assert r.status == 409 and await r.json() == {
            "success": False, "error": f"profiler already tracing to {d}"}
        torch.ones(4).sum()
        r = await c.post("/api/extra/profiler/stop")
        body = await r.json()
        assert r.status == 200 and body["success"] and body["dir"] == d
        assert body["files"]
        if sub == "port":
            assert body["files"] == ["trace.json"]
            trace = json.load(open(os.path.join(d, "trace.json")))
            assert "traceEvents" in trace
        r = await c.post("/api/extra/profiler/stop")
        assert r.status == 409 and await r.json() == {
            "success": False, "error": "profiler is not tracing"}
