"""CLI launcher: `python -m koboldcpp_tpu_torch model.gguf`.

Port of koboldcpp_tpu/cli.py: the reference's flag names (koboldcpp.py:
4391-4488) with the JAX parser's types and defaults, `.kcpps` JSON config
load / save, URL model download, `--benchmark`, `--nomodel`, LoRA
adapters, the RoPE override and the automatic NTK-aware base, the chat
adapter (`auto` guesses it), smart context or context shift, then the HTTP
server (HTTPS with `--ssl`). The port's own flags: --paged / --pagesize
(the paged KV pool of `--multiuser N`) and --device. The GPU-backend flags
of the reference are accepted and ignored, but `--usecpu` runs on the CPU.
`--mmproj` loads a LLaVA vision projector (models/clip.py) into whichever
engine serves, `--whispermodel` a Whisper model (models/whisper.py) for
the transcribe routes, `--sdmodel` a Stable Diffusion GGUF (models/sd.py)
for the A1111 txt2img / img2img routes, with `--sdvae` (a standalone
VAE), `--sdlora` / `--sdloramult` (a LoRA merged at load), `--sdtaesd`
(TAESD weights decoding in place of the VAE; `--sdvaeauto` alone says it
needs them) and `--sdclamped` (the shared-hosting clamps);
`--ignoremissing` skips any of these when its file is missing, as it does
a LoRA. Beyond the JAX launcher, `--sdmodel` without a text model (or with
`--nomodel`) serves the image routes alone, as upstream's image-only
mode does. `--hordekey` with `--hordeworkername` runs the AI Horde worker
(server/horde.py), `--remotetunnel` a cloudflared tunnel
(server/tunnel.py), and with no model the tkinter launcher (gui.py)
opens unless `--skiplauncher` is given.

Parallel serving (parallel/): `--mesh dp,tp` shards the model over dp x
tp ranks (tensor parallel heads and FFN columns of every architecture the
JAX package shards, expert stacks over tp; data parallel slots of
`--multiuser`), `--pipeline N` runs N layer stages, `--seqparallel N`
shards the context over N ranks (the llama-family decoders; any other
model takes its own branch unsharded, as in JAX); the launcher starts
the other ranks itself, one process a GPU (cuda:<rank>, NCCL; the CPU
ranks of --device cpu over gloo), and a mesh of more ranks than visible
GPUs raises.
`--coordinator host:port --numprocesses N --processid i` joins N
processes started by hand (multi-host): host 0 serves HTTP and the others
replay its engine calls in lockstep (parallel/multihost.py). Runs on the
GPU unless --device cpu or --usecpu is given.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.request

# accepted for compatibility and ignored (the reference's backend
# selection); --usecpu selects the CPU
COMPAT_FLAGS = ("--usecublas", "--usevulkan", "--useclblast", "--usecpu",
                "--gpulayers", "--tensor_split", "--blasbatchsize",
                "--blasthreads", "--threads", "--highpriority", "--usemmap",
                "--usemlock", "--noavx2", "--failsafe", "--nommap")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="koboldcpp-tpu-torch",
        description="KoboldCpp-compatible LLM server on PyTorch/CUDA")
    p.add_argument("model_param", nargs="?", default="",
                   help="GGUF model file or URL (positional)")
    p.add_argument("port_param", nargs="?", default="",
                   help="port (positional compat)")
    p.add_argument("--model", default="", help="GGUF model file or URL")
    p.add_argument("--lora", nargs="+", default=None, metavar="FILE",
                   help="GGUF LoRA adapter(s) to merge into the model at load")
    p.add_argument("--loramult", type=float, default=1.0,
                   help="LoRA strength multiplier")
    p.add_argument("--port", type=int, default=5001)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--password", default="", help="API key (Bearer auth)")
    p.add_argument("--multiuser", type=int, nargs="?", const=5, default=1,
                   help="max concurrent requests; > 1 serves them by "
                        "continuous batching over that many KV slots")
    p.add_argument("--contextsize", type=int, default=2048)
    p.add_argument("--maxrequestsize", type=int, default=32,
                   help="accepted for compatibility")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--debugmode", type=int, default=0,
                   help="accepted for compatibility; the profiler is at "
                        "/api/extra/profiler/start|stop")
    p.add_argument("--config", default="", help=".kcpps JSON config file")
    p.add_argument("--chatcompletionsadapter", default="",
                   help="chat template adapter name or JSON file, or auto")
    p.add_argument("--preloadstory", default="", help="story JSON to preload")
    p.add_argument("--benchmark", nargs="?", const="stdout", default=None,
                   help="run benchmark then exit; optional CSV filename")
    p.add_argument("--prompt", default="", help="one-shot prompt mode")
    p.add_argument("--promptlimit", type=int, default=100)
    p.add_argument("--defaultgenamt", type=int, default=512,
                   help="accepted for compatibility")
    p.add_argument("--quantkv", type=int, default=0, choices=(0, 1, 2),
                   help="KV cache quantization: 0=bf16 1=q8 2=q4")
    p.add_argument("--flashattention", action="store_true",
                   help="accepted for compatibility; prefill from position "
                        "0 always runs flash attention on the GPU")
    p.add_argument("--nocontextshift", action="store_true")
    p.add_argument("--noshift", action="store_true")
    p.add_argument("--smartcontext", action="store_true",
                   help="legacy smart-context (halve-and-buffer) instead of "
                        "context shift")
    p.add_argument("--nofastforward", action="store_true",
                   help="accepted for compatibility")
    p.add_argument("--remotetunnel", action="store_true",
                   help="create a trycloudflare tunnel for remote access")
    p.add_argument("--ropeconfig", nargs=2, type=float, default=None,
                   metavar=("SCALE", "BASE"))
    for flag in COMPAT_FLAGS:
        p.add_argument(flag, nargs="?", const=True, default=None,
                       help=argparse.SUPPRESS)
    p.add_argument("--hordekey", default="")
    p.add_argument("--hordeworkername", default="")
    p.add_argument("--hordemodelname", default="")
    p.add_argument("--hordemaxctx", type=int, default=0)
    p.add_argument("--hordegenlen", type=int, default=0)
    p.add_argument("--mesh", default="", help="dp,tp mesh shape e.g. 1,2; "
                   "shards weights/KV over that many GPU ranks (TP serving)")
    p.add_argument("--pipeline", type=int, default=0, metavar="N",
                   help="pipeline parallelism: shard layers into N stages "
                   "over N GPU ranks (GPipe microbatch schedule)")
    p.add_argument("--seqparallel", type=int, default=0, metavar="N",
                   help="sequence parallelism: shard the KV cache's context "
                   "axis over N GPU ranks (ring-attention prefill + "
                   "distributed decode)")
    # multi-host serving (torch.distributed): run the same command on
    # every host, host 0 serves HTTP, the rest follow in lockstep
    p.add_argument("--coordinator", default="",
                   help="host0 address host:port for torch.distributed")
    p.add_argument("--numprocesses", type=int, default=1,
                   help="total process count for multi-host serving")
    p.add_argument("--processid", type=int, default=0,
                   help="this process's id (0 = HTTP server host)")
    p.add_argument("--paged", action="store_true",
                   help="paged KV pool for the continuous-batching engine")
    p.add_argument("--pagesize", type=int, default=64)
    p.add_argument("--skiplauncher", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--ssl", nargs=2, metavar=("CERT", "KEY"), default=None,
                   help="serve HTTPS with this certificate/key PEM pair")
    p.add_argument("--nocertify", action="store_true",
                   help="disable SSL certificate verification for outbound "
                        "requests (horde, model downloads)")
    p.add_argument("--onready", default="", metavar="CMD",
                   help="shell command to run once the server is ready")
    p.add_argument("--launch", action="store_true",
                   help="open the web UI in a browser once the server starts")
    p.add_argument("--nomodel", action="store_true",
                   help="start the server with no text model loaded "
                        "(UI + API shell)")
    p.add_argument("--mmproj", default="", help="LLaVA mmproj GGUF (vision)")
    p.add_argument("--whispermodel", default="", help="whisper GGUF model")
    p.add_argument("--sdmodel", default="", help="stable-diffusion GGUF model")
    p.add_argument("--sdvaeauto", action="store_true",
                   help="use TAESD instead of the VAE (needs --sdtaesd weights)")
    p.add_argument("--sdtaesd", default="", help="TAESD weights (.safetensors/.pt)")
    p.add_argument("--sdvae", default="",
                   help="standalone SD VAE to load in place of the model's "
                        "(.safetensors or converted .gguf)")
    p.add_argument("--sdlora", default="", help="SD LoRA adapter GGUF to merge")
    p.add_argument("--sdloramult", type=float, default=1.0,
                   help="SD LoRA multiplier")
    p.add_argument("--sdclamped", type=int, nargs="?", const=512, default=0,
                   help="clamp SD resolution/steps for shared hosting")
    p.add_argument("--ignoremissing", action="store_true",
                   help="skip missing non-essential files (lora, mmproj, "
                        "whisper, sd) instead of failing")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch versions of the kernels)")
    return p


def load_kcpps(path: str, args: argparse.Namespace):
    """Apply a .kcpps JSON config over the args namespace (koboldcpp.py:3757)."""
    with open(path) as f:
        cfg = json.load(f)
    for k, v in cfg.items():
        if hasattr(args, k):
            setattr(args, k, v)
    return args


def save_kcpps(path: str, args: argparse.Namespace):
    skip = {"model_param", "port_param", "config"}
    data = {k: v for k, v in vars(args).items() if k not in skip}
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def download_model_from_url(url: str, dest_dir: str = ".") -> str:
    """URL model fetch (koboldcpp.py:3808)."""
    name = url.split("?")[0].rstrip("/").split("/")[-1] or "model.gguf"
    dest = os.path.join(dest_dir, name)
    if not os.path.exists(dest):
        print(f"Downloading {url} -> {dest}")
        urllib.request.urlretrieve(url, dest)
    return dest


def apply_rope_config(cfg, ropeconfig, contextsize: int) -> str | None:
    """The launcher's RoPE decision (gpttype_adapter.cpp:1926; the JAX
    launcher's, cli.py:336-357) on a loaded config, in place: an explicit
    --ropeconfig SCALE BASE sets rope_theta to BASE and, for a scale other
    than 1, linear scaling by 1/SCALE; else, when the context exceeds the
    trained one and the model ships no scaling of its own, the NTK-aware
    base (solar models by their name rule). Returns the line to print, or
    None."""
    from .ops.rope import gradientai_rope_base

    if ropeconfig:
        scale, base = ropeconfig
        cfg.rope_theta = float(base)
        if scale and scale > 0 and scale != 1.0:
            cfg.rope_scaling_type = "linear"
            cfg.rope_scaling_factor = 1.0 / float(scale)
        return f"RoPE override: base={base} scale={scale}"
    if (contextsize > cfg.max_position_embeddings
            and cfg.rope_scaling_type in ("none", "")):
        new_base = gradientai_rope_base(
            cfg.rope_theta, cfg.head_dim, contextsize,
            cfg.max_position_embeddings,
            solar="solar" in (cfg.name or "").lower())
        if new_base != cfg.rope_theta:
            line = (f"Auto RoPE (NTK-aware): base {cfg.rope_theta:.0f} -> "
                    f"{new_base:.0f} for context {contextsize}")
            cfg.rope_theta = new_base
            return line
    return None


def run_benchmark(engine, csv_path: str | None):
    """--benchmark mode (koboldcpp.py:4274-4353): one pp+tg pass, T/s report."""
    from .engine import GenParams
    from .sampling import SamplerParams

    n_prompt = min(engine.max_context - 256, 2048)
    prompt_tokens = [engine.tokenizer.vocab.bos_id] + [8] * (n_prompt - 1)
    genamt = 100
    t0 = time.time()
    result = engine.generate(prompt_tokens, GenParams(
        max_length=genamt,
        sampler=SamplerParams(temperature=0.1, top_k=1, rep_pen=1.0),
        bypass_eos=True))
    total = time.time() - t0
    t = result.timings
    line = (f"ProcessingTime: {t.prompt_time:.2f}s ProcessingSpeed: {t.prompt_tps:.2f}T/s "
            f"GenerationTime: {t.gen_time:.2f}s GenerationSpeed: {t.gen_tps:.2f}T/s "
            f"TotalTime: {total:.2f}s")
    print(line)
    if csv_path and csv_path != "stdout":
        import csv as _csv
        new = not os.path.exists(csv_path)
        with open(csv_path, "a", newline="") as f:
            w = _csv.writer(f)
            if new:
                w.writerow(["Timestamp", "Backend", "Layers", "Model", "MaxCtx",
                            "GenAmount", "ProcessingTime", "ProcessingSpeed",
                            "GenerationTime", "GenerationSpeed", "TotalTime",
                            "Output", "Flags"])
            w.writerow([int(time.time()), "cuda", "all", "model",
                        engine.max_context, genamt,
                        f"{t.prompt_time:.2f}", f"{t.prompt_tps:.2f}",
                        f"{t.gen_time:.2f}", f"{t.gen_tps:.2f}",
                        f"{total:.2f}", result.text[:20], ""])
    return result


class NullEngine:
    """--nomodel: the API shell with no text model (upstream's --nomodel
    serves the UI and docs with generation inactive)."""

    def __init__(self, max_context: int = 2048):
        from .engine.engine import GenerationResult, Timings

        self.max_context = max_context
        self.tokenizer = None
        self.last_timings = Timings()
        self.total_gens = 0
        self.generation_finished = True
        self.stream_tokens = []
        self._res = GenerationResult

    def generate(self, prompt, params, on_token=None, genkey=""):
        return self._res(text="", stop_reason="error: no model loaded")

    def abort(self, genkey: str = ""):
        pass

    def token_count(self, text: str) -> list:
        return []

    def reset_context(self):
        pass

    def shutdown(self):
        pass


def _chat_adapter(args, model):
    """--chatcompletionsadapter: a JSON file, a built-in name, or `auto`
    (guessed from the vocabulary's control tokens, then the model name)."""
    chat_adapter = args.chatcompletionsadapter or None
    if chat_adapter and os.path.exists(chat_adapter):
        with open(chat_adapter) as f:
            return json.load(f)
    if chat_adapter and chat_adapter.lower() in ("auto", "autoguess"):
        from .server.adapters import guess_adapter

        vocab_tokens = set(getattr(model.tokenizer.vocab, "tokens", None)
                           or [])
        guessed = guess_adapter(
            getattr(model.cfg, "name", "")
            or os.path.basename(args.model or ""), vocab_tokens)
        print(f"Chat adapter autodetect: {guessed or 'no match (raw prompts)'}")
        return guessed
    return chat_adapter


def _skip_missing(args) -> None:
    """--ignoremissing: clear each optional model file that is missing."""
    for attr in ("mmproj", "sdmodel", "whispermodel", "sdtaesd", "sdvae",
                 "sdlora"):
        v = getattr(args, attr, "")
        if v and not os.path.exists(v):
            print(f"--ignoremissing: skipping missing {attr} {v}")
            setattr(args, attr, "")


def _load_sd(args, device):
    """--sdmodel and its sub-flags (the JAX launcher's order and
    messages): the model with its VAE override and LoRA, then TAESD."""
    if not args.sdmodel:
        return None
    from .models.sd import load_sd

    print(f"Loading SD model: {args.sdmodel}")
    sd_loras = [(args.sdlora, args.sdloramult)] if args.sdlora else None
    sd_model = load_sd(args.sdmodel, loras=sd_loras,
                       vae_path=args.sdvae or None, device=device)
    if args.sdtaesd:
        print(f"Loading TAESD: {args.sdtaesd}")
        sd_model.set_taesd(args.sdtaesd)
    elif args.sdvaeauto:
        print("--sdvaeauto requires --sdtaesd <weights>; using full VAE")
    return sd_model


class _Parallel:
    """The parallel forms of one run: the process group's meshes, this
    process's rank and device, and the follower processes it started."""

    def __init__(self):
        self.mesh = self.pp_mesh = self.sp_mesh = self.topo = None
        self.rank = 0
        self.device = None
        self.procs: list = []
        self.launched = False  # the launcher's ranks (step mirror)

    @property
    def follower(self) -> bool:
        return self.rank != 0


def _start_ranks(par: _Parallel, world: int, device, rank, argv) -> None:
    """Join (rank = (r, world, init) of a follower) or start (the
    launcher: ranks 1.. of `world`, after building the kernels once) the
    launcher's process group: cuda:<rank> over NCCL, or CPU ranks over
    gloo."""
    import torch

    from .parallel import comm, launch

    cpu = device is not None and torch.device(device).type == "cpu"
    if rank is None:
        init = f"tcp://127.0.0.1:{comm.free_port()}"
        if not cpu:
            from .ops import _build

            _build.build_all()  # once, before the other ranks look for it
        par.procs = launch.spawn_ranks(
            list(sys.argv[1:] if argv is None else argv), world, init)
        r = 0
    else:
        r, world, init = rank
    par.rank, par.launched = r, True
    par.device = torch.device("cpu") if cpu else torch.device("cuda", r)
    if cpu:  # the ranks share the host's cores
        torch.set_num_threads(max(1, min(torch.get_num_threads(),
                                         (os.cpu_count() or 1) // world)))
    else:
        torch.cuda.set_device(par.device)
    comm.init("gloo" if cpu else "nccl", init, world, r)


def _rank_devices(par: _Parallel, n: int) -> list:
    """Each rank's device: the launcher's ranks cuda:<rank> (or the CPU);
    under multi-host only this process's own device is known."""
    if par.topo is not None or par.device.type == "cpu":
        return [par.device] * n
    return [("cuda", r) for r in range(n)]


def _setup_parallel(args, device, rank, argv, model_path) -> _Parallel:
    """The JAX launcher's parallel branches (cli.py:298-302, 358-431) over
    torch.distributed: multi-host lockstep, `--mesh`, `--seqparallel` and
    `--pipeline`, with its notes where a form is ignored. A model off the
    llama-family path (models/loader.py `arch_module`) is served by its
    own branch, unsharded, under --seqparallel / --pipeline, as the JAX
    engine serves it: no follower rank starts."""
    import torch

    from .models.loader import arch_module, model_arch

    par = _Parallel()
    par.device = None if device is None else torch.device(device)
    cpu = par.device is not None and par.device.type == "cpu"
    if args.coordinator and args.numprocesses > 1:
        from .parallel import multihost

        if not cpu:
            n = max(torch.cuda.device_count(), 1)
            par.device = torch.device("cuda", args.processid % n)
        par.topo = multihost.initialize(
            args.coordinator, args.numprocesses, args.processid,
            "gloo" if cpu else "nccl", par.device)
        par.rank = par.topo.host_id
        print(f"torch.distributed: host {par.topo.host_id}/"
              f"{par.topo.n_hosts}, {par.topo.n_devices_global} global "
              "devices")
    have = None if cpu else torch.cuda.device_count()
    if par.topo is not None:
        have = par.topo.n_devices_global
    if args.mesh:
        dp, tp = (int(x) for x in args.mesh.split(","))
        if par.topo is None and dp * tp > 1:
            if have is not None and dp * tp > have:
                raise ValueError(f"--mesh {args.mesh} needs {dp * tp} GPUs "
                                 f"(have {have})")
            _start_ranks(par, dp * tp, device, rank, argv)
    # sequence, then pipeline parallelism (the JAX launcher's order)
    axis = n = None
    if args.seqparallel > 1:
        if have is not None and have < args.seqparallel:
            print(f"Note: --seqparallel {args.seqparallel} needs that many "
                  f"devices (have {have}); ignoring")
        elif args.mesh or args.multiuser > 1 or args.pipeline:
            print("Note: --seqparallel is exclusive with --mesh/--pipeline/"
                  "--multiuser batching in this round; ignoring")
        else:
            axis, n = "sp", args.seqparallel
    if args.pipeline > 1 and axis is None:
        if have is not None and have < args.pipeline:
            print(f"Note: --pipeline {args.pipeline} needs that many devices "
                  f"(have {have}); ignoring")
        elif args.mesh or args.multiuser > 1:
            print("Note: --pipeline is exclusive with --mesh/--multiuser "
                  "batching in this round; ignoring")
        else:
            axis, n = "pp", args.pipeline
    arch = model_arch(model_path) if axis is not None else None
    if arch is not None and arch_module(arch) is not None:
        print(f"Note: --{'seqparallel' if axis == 'sp' else 'pipeline'} {n} "
              f"serves the llama-family decoders; {arch} runs its own "
              "branch unsharded, as in the JAX engine")
        axis = None
    if axis is not None and par.topo is not None and n != par.topo.n_hosts:
        print(f"Note: --{'seqparallel' if axis == 'sp' else 'pipeline'} {n} "
              f"must span the {par.topo.n_hosts} hosts; ignoring")
        axis = None
    if axis is not None:
        from .parallel.sharding import Mesh

        if par.topo is None:
            _start_ranks(par, n, device, rank, argv)
        mesh = Mesh({axis: n}, _rank_devices(par, n))
        if axis == "sp":
            par.sp_mesh = mesh
            print(f"Sequence parallelism: {n}-way sharded KV")
        else:
            par.pp_mesh = mesh
            print(f"Pipeline parallelism: {n} stages")
    elif args.mesh and (par.launched or par.topo is not None) or (
            par.topo is not None and par.topo.n_hosts > 1):
        from .parallel import multihost
        from .parallel.sharding import make_mesh

        if args.mesh:
            dp, tp = (int(x) for x in args.mesh.split(","))
            par.mesh = make_mesh(dp=dp, tp=tp,
                                 devices=_rank_devices(par, dp * tp))
        else:
            par.mesh = multihost.global_mesh(
                par.topo, devices=_rank_devices(par, par.topo.n_hosts))
        print(f"Device mesh: dp={par.mesh.shape['dp']} "
              f"tp={par.mesh.shape['tp']} ({par.mesh.size} devices)")
    return par


def main(argv=None, rank=None):
    """The launcher. rank: (rank, world, init address) when this process
    is a follower rank that the launcher started (parallel/launch.py)."""
    args = build_parser().parse_args(argv)
    if args.config:
        load_kcpps(args.config, args)
    if args.nocertify:
        # outbound TLS without verification (model downloads behind a
        # proxy that re-signs)
        import ssl as _ssl

        _ssl._create_default_https_context = _ssl._create_unverified_context
        print("SSL certificate verification DISABLED for outbound requests")
    model_path = args.model or args.model_param
    if args.model_param and args.model_param.endswith((".kcpps", ".kcppt")):
        load_kcpps(args.model_param, args)
        model_path = args.model
    from .server.app import ServerSettings, run_server

    device = args.device or ("cpu" if args.usecpu else None)
    if args.ignoremissing:
        _skip_missing(args)
    if args.nomodel or (not model_path and args.sdmodel):
        print("--nomodel: starting API shell without a text model"
              if args.nomodel else
              "--sdmodel without a text model: serving the image routes")
        settings = ServerSettings(password=args.password,
                                  model_name="inactive", quiet=args.quiet,
                                  sd_model=_load_sd(args, device),
                                  sd_clamped=args.sdclamped)
        print(f"Starting server on {args.host}:{args.port}")
        run_server(NullEngine(args.contextsize), host=args.host,
                   port=args.port, settings=settings, ssl_pair=args.ssl,
                   onready=args.onready, launch=args.launch)
        return 0
    if not model_path:
        if not args.skiplauncher:
            try:  # reference behaviour: no model -> the GUI launcher
                from .gui import show_gui

                argv2 = show_gui()
                if argv2:
                    return main(argv2)
            except Exception:  # noqa: BLE001 (no display, no tkinter)
                pass
        print("error: no model specified (pass a GGUF path or --model)")
        return 2
    if model_path.startswith(("http://", "https://")):
        model_path = download_model_from_url(model_path)
    if args.port_param:
        try:
            args.port = int(args.port_param)
        except ValueError:
            pass

    par = _setup_parallel(args, device, rank, argv, model_path)
    try:
        out = _serve(args, model_path, par)
    except BaseException:
        for p in par.procs:  # the followers would wait for rank 0
            p.terminate()
        raise
    for p in par.procs:
        p.wait()
    return out


def _serve(args, model_path: str, par: _Parallel) -> int:
    """Load, shard, build the engine, then serve (or follow rank 0)."""
    from .engine import Engine, GenParams
    from .engine.batch_engine import BatchedEngine, batch_capable
    from .models.loader import load_model
    from .parallel import launch
    from .server.app import ServerSettings, run_server

    device = par.device
    multi_host = par.topo is not None and par.topo.n_hosts > 1
    print(f"Loading model: {model_path}")
    t0 = time.time()
    loras = [(lp, args.loramult) for lp in (args.lora or [])]
    if args.ignoremissing:
        for lp, _ in loras:
            if not os.path.exists(lp):
                print(f"--ignoremissing: skipping missing lora {lp}")
        loras = [(lp, m) for lp, m in loras if os.path.exists(lp)]
    if loras:
        print(f"Applying {len(loras)} LoRA adapter(s), multiplier "
              f"{args.loramult}")
    model = load_model(model_path, device=device, loras=loras or None)
    print(f"Load took {time.time() - t0:.1f}s ({model.cfg.arch}, "
          f"{model.cfg.n_layers} layers, vocab {model.cfg.vocab_size}) "
          f"on {model.device}")
    line = apply_rope_config(model.cfg, args.ropeconfig, args.contextsize)
    if line:
        print(line)
    from .models.llama import flash_decode_note

    line = flash_decode_note()
    if line:
        print(line)
    if par.mesh is not None:
        from .parallel import shard_model

        model = shard_model(model, par.mesh)
    clip_model = None
    if args.mmproj:
        from .models.clip import load_clip

        print(f"Loading mmproj: {args.mmproj}")
        clip_model = load_clip(args.mmproj, device=model.device)

    # smart context is a single-sequence path, and so is multi-host
    # lockstep (one deterministic request stream): --multiuser > 1 routes
    # them to the single engine, as the JAX launcher does
    batched = (args.multiuser > 1 and batch_capable(model.cfg)
               and not args.smartcontext and not multi_host)
    if args.multiuser > 1 and not batched:
        print(f"Note: --multiuser continuous batching is unavailable for "
              f"this configuration (arch {model.cfg.arch}"
              + (", smartcontext" if args.smartcontext else "")
              + "); serving with the single-sequence engine + FIFO queue")
    # multi-host lockstep replays the one stream on every host: its dp
    # indices (the hosts of the global mesh) each compute the whole batch
    if (par.mesh is not None and par.mesh.shape["dp"] > 1 and not batched
            and not multi_host):
        raise ValueError(f"a batch of 1 does not divide over "
                         f"dp={par.mesh.shape['dp']} (data parallelism "
                         "shards the slots of --multiuser)")
    if args.paged and args.quantkv == 2:
        print("Paged KV pool: Q4 (plane-split nibbles, half the Q8 memory)")
    shift = not (args.noshift or args.nocontextshift)
    if batched:
        # --quantkv 1 takes the paged Q8 pool (the JAX launcher's routing,
        # cli.py:432-446)
        paged = args.paged or args.quantkv == 1
        engine = BatchedEngine(model, max_context=args.contextsize,
                               n_slots=args.multiuser, paged=paged,
                               page_size=args.pagesize, device=model.device,
                               quantkv=args.quantkv, use_contextshift=shift,
                               clip_model=clip_model, mesh=par.mesh)
        print(f"Continuous batching enabled: {args.multiuser} KV slots"
              + (" (paged)" if paged else ""))
    else:
        engine = Engine(model, max_context=args.contextsize,
                        device=model.device, quantkv=args.quantkv,
                        use_smartcontext=args.smartcontext,
                        use_contextshift=shift, clip_model=clip_model,
                        pp_mesh=par.pp_mesh, sp_mesh=par.sp_mesh)
        if args.quantkv == 1:
            print("Q8-quantized KV cache enabled")
        elif args.quantkv == 2:
            print("Q4_0-quantized KV cache enabled (plain attention path)")

    if par.launched:
        import torch.distributed as dist

        from .parallel import comm

        world = comm.world_group()
        if par.follower:
            print(f"Rank {par.rank}: following rank 0's steps")
            launch.follow(engine, world)
            if isinstance(engine, BatchedEngine):
                engine.shutdown()
            dist.destroy_process_group()
            return 0
        launch.mirror(engine, world, engine.MIRRORED_STEPS)
    lockstep = None
    if multi_host:
        from .parallel.multihost import (LockstepEngine, announce_shutdown,
                                         follower_loop)

        if par.topo.is_follower:
            import torch.distributed as dist

            print(f"Follower host {par.topo.host_id}: entering lockstep loop")
            follower_loop(engine)
            dist.barrier()
            dist.destroy_process_group()
            return 0
        engine = lockstep = LockstepEngine(engine, par.topo)
    try:
        return _run_front(args, model_path, model, engine, ServerSettings,
                          run_server, GenParams)
    finally:
        inner = getattr(engine, "_engine", engine)
        if isinstance(inner, BatchedEngine):
            inner.shutdown()
        if par.launched:
            import torch.distributed as dist

            launch.stop(inner)
            dist.destroy_process_group()
        if lockstep is not None:
            import torch.distributed as dist

            announce_shutdown()
            dist.barrier()
            dist.destroy_process_group()


def _run_front(args, model_path, model, engine, ServerSettings, run_server,
               GenParams) -> int:
    """The benchmark, the one-shot prompt or the HTTP server (with the
    horde worker and the tunnel)."""
    if args.benchmark is not None or args.prompt:
        if args.benchmark is not None:
            run_benchmark(engine, args.benchmark)
        else:
            r = engine.generate(args.prompt,
                                GenParams(max_length=args.promptlimit))
            print(r.text)
        return 0

    story = None
    if args.preloadstory and os.path.exists(args.preloadstory):
        with open(args.preloadstory) as f:
            story = json.load(f)
    sd_model = _load_sd(args, model.device)
    whisper_model = None
    if args.whispermodel:
        from .models.whisper import load_whisper

        print(f"Loading whisper model: {args.whispermodel}")
        whisper_model = load_whisper(args.whispermodel, device=model.device)
    settings = ServerSettings(password=args.password,
                              model_name=os.path.basename(model_path),
                              multiuser=args.multiuser,
                              chat_adapter=_chat_adapter(args, model),
                              preloaded_story=story, quiet=args.quiet,
                              whisper_model=whisper_model, sd_model=sd_model,
                              sd_clamped=args.sdclamped)
    if args.hordekey and args.hordeworkername:
        from .server.horde import start_horde_worker

        start_horde_worker(args, settings)
    print(f"Starting server on {args.host}:{args.port}")
    tunnel = None
    if args.remotetunnel:
        from .server.tunnel import Tunnel

        tunnel = Tunnel(args.port)
        tunnel.start()
    try:
        run_server(engine, host=args.host, port=args.port, settings=settings,
                   ssl_pair=args.ssl, onready=args.onready,
                   launch=args.launch)
    finally:
        if tunnel is not None:
            tunnel.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
