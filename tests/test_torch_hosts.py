"""The port's host modules against the JAX package's: the launcher GUI's
schema and argv (gui.py, over the port's parser), the cloudflared tunnel
and the AI Horde worker (server/tunnel.py, server/horde.py: copies of the
JAX modules), the KoboldAI United backend (united.py, over the port's
Engine), and the launcher's wiring of them and of `--skiplauncher` (its
`--mesh` launch is tests/test_torch_parallel.py's). CPU, the committed
Q4_K_M fixture."""
import argparse
import json
import os
import shutil
import stat

import numpy as np
import pytest
import torch

from koboldcpp_tpu import gui as jgui
from koboldcpp_tpu.server import horde as jhorde
from koboldcpp_tpu_torch import cli, gui, united
from koboldcpp_tpu_torch.server import app as tapp
from koboldcpp_tpu_torch.server import horde, tunnel

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures", "refgguf", "tiny-q4_k_m.gguf")


def test_gui_build_argv():
    """The JAX test's form values give the same argv, which the port's
    parser reads back."""
    values = {"model": "m.gguf", "port": 5002, "contextsize": 4096,
              "multiuser": 4, "password": "", "benchmark": True}
    argv = gui.build_argv(values)
    assert argv == jgui.build_argv(values)
    assert argv[0] == "m.gguf" and "--password" not in argv
    assert argv[argv.index("--port") + 1] == "5002" and "--benchmark" in argv
    ns = cli.build_parser().parse_args(argv)
    assert ns.contextsize == 4096 and ns.multiuser == 4


def test_gui_schema_covers_every_cli_flag():
    """Every flag of the port's parser that is not hidden appears in one
    tab, the parallel ones in "Parallel" as in the JAX form, and argv
    (nargs flags too) round-trips through the parser."""
    schema = gui.gui_schema()
    names = [f["name"] for _, fs in schema for f in fs]
    assert len(names) == len(set(names)), "flag in two tabs"
    want = {a.dest for a in cli.build_parser()._actions
            if a.option_strings and a.dest not in gui._HIDDEN
            and not isinstance(a, argparse._HelpAction)
            and a.help != argparse.SUPPRESS}
    assert set(names) == want, set(names) ^ want
    tabs = dict(schema)
    assert {"mesh", "coordinator", "numprocesses", "processid"} <= {
        f["name"] for f in tabs["Parallel"]}
    argv = gui.build_argv({"model": "/tmp/m.gguf", "port": 5099,
                           "multiuser": 4, "paged": True,
                           "contextsize": 4096, "mesh": "1,2"})
    args = cli.build_parser().parse_args(argv)
    assert args.model_param == "/tmp/m.gguf" and args.mesh == "1,2"
    assert args.port == 5099 and args.multiuser == 4 and args.paged
    args = cli.build_parser().parse_args(
        gui.build_argv({"ropeconfig": "0.5 20000", "lora": "/a.gguf"}))
    assert args.ropeconfig == [0.5, 20000.0] and args.lora == ["/a.gguf"]


def test_host_modules_are_the_jax_packages():
    """server/horde.py and server/tunnel.py are the JAX package's, line for
    line but the docstring's pointer to upstream."""
    for name in ("horde", "tunnel"):
        a = open(os.path.join(ROOT, "koboldcpp_tpu", "server",
                              f"{name}.py")).read().splitlines()
        b = open(os.path.join(ROOT, "koboldcpp_tpu_torch", "server",
                              f"{name}.py")).read().splitlines()
        assert len(a) == len(b)
        assert [i for i, (x, y) in enumerate(zip(a, b)) if x != y] == [2]


def test_tunnel_url_scrape(tmp_path):
    """The URL scraped from a fake cloudflared's stderr, then stopped."""
    fake = tmp_path / "fake_cloudflared"
    fake.write_text("#!/bin/sh\n"
                    "echo 'INF +--------------------+' 1>&2\n"
                    "echo 'INF https://abc-def-demo.trycloudflare.com' 1>&2\n"
                    "sleep 30\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    t = tunnel.Tunnel(5001, binary=str(fake))
    assert t.start(timeout=10) == "https://abc-def-demo.trycloudflare.com"
    t.stop()
    assert t.proc is None


class _Resp:
    def __init__(self, body: dict):
        self.body = json.dumps(body).encode()

    def read(self):
        return self.body

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _horde_run(mod, monkeypatch) -> list:
    """One job through `mod`'s worker against a fake horde and a fake
    local API: the calls it made."""
    import threading

    calls = []
    stop = threading.Event()

    def post(url, payload, apikey="0000000000"):
        calls.append((url.rsplit("/", 1)[-1], payload, apikey))
        if url.endswith("pop"):
            return {"id": "job-12345678", "payload": {"max_length": 4},
                    "prompt": "hello"}
        stop.set()
        return {}

    def urlopen(req, timeout=0):
        calls.append(("local", json.loads(req.data), req.full_url))
        return _Resp({"results": [{"text": " world"}]})

    monkeypatch.setattr(mod, "_post", post)
    monkeypatch.setattr(mod.urllib.request, "urlopen", urlopen)
    args = argparse.Namespace(port=5123, hordekey="k", hordeworkername="w",
                              hordemodelname="", hordemaxctx=0,
                              hordegenlen=0)
    mod.run_horde_worker(args, argparse.Namespace(model_name="m"), stop)
    return calls


def test_horde_worker_job_matches_jax(monkeypatch):
    """A popped job runs against the local API and its text is submitted;
    the same calls as the JAX worker's."""
    calls = _horde_run(horde, monkeypatch)
    assert calls == _horde_run(jhorde, monkeypatch)
    assert calls[0][0] == "pop" and calls[0][1]["models"] == ["m"]
    assert calls[1][1]["prompt"] == "hello"
    assert calls[2][1] == {"id": "job-12345678", "generation": " world",
                           "state": "ok"}


class _Served(Exception):
    pass


def test_launcher_starts_the_horde_worker_and_the_tunnel(monkeypatch):
    """--hordekey with --hordeworkername starts the worker and
    --remotetunnel a tunnel on the server's port before it serves."""
    seen = {}

    class FakeTunnel:
        def __init__(self, port):
            seen["tunnel_port"] = port

        def start(self):
            seen["tunnel_started"] = True

        def stop(self):
            seen["tunnel_stopped"] = True

    def fake_run(engine, **kw):
        raise _Served

    monkeypatch.setattr(tunnel, "Tunnel", FakeTunnel)
    monkeypatch.setattr(horde, "start_horde_worker",
                        lambda a, s: seen.update(horde=(a.hordekey,
                                                        s.model_name)))
    monkeypatch.setattr(tapp, "run_server", fake_run)
    with pytest.raises(_Served):
        cli.main([FIX, "--device", "cpu", "--port", "5077", "--hordekey",
                  "k", "--hordeworkername", "w", "--remotetunnel"])
    assert seen == {"horde": ("k", "tiny-q4_k_m.gguf"), "tunnel_port": 5077,
                    "tunnel_started": True, "tunnel_stopped": True}


def test_skiplauncher_without_a_model_exits(capsys, monkeypatch):
    """No model: --skiplauncher goes straight to the error; without it the
    GUI launcher is tried first (here it opens nothing)."""
    opened = []
    monkeypatch.setattr(gui, "show_gui", lambda: opened.append(1))
    assert cli.main(["--skiplauncher"]) == 2 and not opened
    assert cli.main([]) == 2 and opened == [1]
    assert "no model specified" in capsys.readouterr().out


def test_united_backend_flow(tmp_path):
    """The JAX test's United flow over the port's Engine on the CPU: model
    discovery, the parameter list, load, two greedy generates (a list and
    an ndarray prompt) with the same tokens, unload."""
    path = str(tmp_path / "united.gguf")
    shutil.copy(FIX, path)
    be = united.model_backend()
    assert be.is_valid("m", str(tmp_path), "")
    assert not be.is_valid("m", str(tmp_path / "nope"), "")
    reqs = be.get_requested_parameters("m", str(tmp_path), "")
    assert {"kcpp_filename", "kcpp_ctxsize", "kcpp_smartcontext",
            "kcpp_quantkv"} <= {r["id"] for r in reqs}
    assert reqs[0]["children"][0]["value"] == path
    be.set_input_parameters({"kcpp_filename": path, "kcpp_ctxsize": 128,
                             "kcpp_smartcontext": 0, "kcpp_quantkv": 0,
                             "kcpp_device": "cpu"})
    be._load()

    class Settings:
        temp, top_k, top_a, top_p, typical, tfs = 0.0, 0, 0.0, 1.0, 1.0, 1.0
        rep_pen, rep_pen_range = 1.0, 0
        sampler_order = (6, 0, 1, 3, 4, 2, 5)

    r = be._raw_generate([1, 5, 9], max_new=6, gen_settings=Settings())
    assert len(r.tokens) == 6
    r2 = be._raw_generate(np.array([1, 5, 9]), max_new=6,
                          gen_settings=Settings())
    assert r2.tokens == r.tokens
    be.unload()
    assert be.engine is None
    with pytest.raises(united.KoboldCppException):
        be._raw_generate([1], max_new=1, gen_settings=Settings())
