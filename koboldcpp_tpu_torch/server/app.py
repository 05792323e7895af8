"""HTTP API server: the text, vision and speech endpoints.

Port of koboldcpp_tpu/server/app.py: KoboldAI
`/api/v1/*` + `/api/extra/*`, OpenAI `/v1/completions` and
`/v1/chat/completions`, ollama `/api/tags`, the embedded KoboldAI Lite page
at `/` and a no-script form at `/noscript`, API docs at `/api`, `/v1` and
`/docs`, the torch.profiler session at `/api/extra/profiler/{start,stop}`,
SSE token streaming in both dialects, Bearer auth, CORS, genkey-based
polling/abort, HTTPS (`ssl_pair`), and the OpenAI `/v1/embeddings` and
`/api/extra/embeddings` over an embedding model (bert, nomic-bert,
jina-bert-v2, t5encoder; `Engine.embed`), whose generate routes answer
400. With an mmproj loaded (the engine's `clip`), a request's `images`
(KoboldAI `images`, OpenAI `image_url` data parts) are spliced into its
prompt, and `/sdapi/v1/interrogate` captions an image (LLaVA). With a
Whisper model (`ServerSettings.whisper_model`), `/api/extra/transcribe`
and `/v1/audio/transcriptions` transcribe a WAV (JSON `audio_data` /
`file` in base64, or a multipart `file`) off the event loop; 503 without
one. With a Stable Diffusion model (`ServerSettings.sd_model`,
models/sd.py), the A1111 `/sdapi/v1/txt2img` and `/sdapi/v1/img2img`
generate a PNG off the event loop (503 without one; resolution and steps
clamped as upstream, tighter under `sd_clamped`), beside the A1111
discovery routes (`sd-models`, `options`, `samplers`,
`latent-upscale-modes`, `upscalers`) and the embedded image page at
`/sdui`.

asyncio (aiohttp) frontend. With the continuous-batching engine
(`BatchedEngine`, `--multiuser N`), requests are submitted to it and
multiplex across its KV slots. The single-sequence `Engine` runs one
generation at a time in a worker thread behind a busy lock, with a FIFO
queue of `multiuser - 1` waiters; a request beyond that gets 503.
"""
from __future__ import annotations

import asyncio
import json
import os
import queue
import time
import uuid
from dataclasses import dataclass, field
from typing import Any

from aiohttp import web

from ..engine import Engine
from .dialects import genparams_to_engine, transform_genparams

KCPP_VERSION = "1.0.0-torch"
API_VERSION = "1.2.2"


@dataclass
class ServerSettings:
    password: str = ""
    model_name: str = "koboldcpp-tpu-torch/model"
    multiuser: int = 1  # max requests served or queued (1 = single user)
    chat_adapter: str | dict | None = None  # instruct template (dialects)
    preloaded_story: Any = None  # --preloadstory JSON
    quiet: bool = False
    whisper_model: Any = None  # models.whisper.WhisperModel
    sd_model: Any = None  # models.sd.SDModel
    sd_clamped: int = 0  # clamp SD res/steps for shared hosting (--sdclamped)


@dataclass
class ActiveGen:
    genkey: str
    engine: Engine
    pieces: queue.Queue = field(default_factory=queue.Queue)
    text_so_far: str = ""
    done: bool = False


class ServerState:
    def __init__(self, engine: Engine, settings: ServerSettings):
        self.engine = engine
        self.settings = settings
        self.busy = asyncio.Lock()
        self.requests_in_queue = 0
        self.active: dict[str, ActiveGen] = {}
        self.pending_abort_keys: set[str] = set()
        self.total_gens = 0
        self.last_req_time = time.time()


STATE = web.AppKey("state", ServerState)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _cors(resp: web.StreamResponse) -> web.StreamResponse:
    resp.headers["Access-Control-Allow-Origin"] = "*"
    resp.headers["Access-Control-Allow-Methods"] = "GET, POST, OPTIONS"
    resp.headers["Access-Control-Allow-Headers"] = "*"
    return resp


def _json(data, status=200):
    return _cors(web.json_response(data, status=status))


def _check_auth(state: ServerState, request: web.Request) -> bool:
    if not state.settings.password:
        return True
    auth = request.headers.get("Authorization", "")
    return auth == f"Bearer {state.settings.password}"


async def _read_json(request: web.Request) -> dict:
    body = await request.read()
    try:
        return json.loads(body) if body else {}
    except (ValueError, UnicodeDecodeError):  # malformed body: no params
        return {}


# ---------------------------------------------------------------------------
# generation plumbing
# ---------------------------------------------------------------------------

def _batched(state: ServerState) -> bool:
    return hasattr(state.engine, "submit")


async def _run_generation(state: ServerState, genparams: dict,
                          api_format: int) -> dict:
    """Run one generation. With the continuous-batching engine, requests
    multiplex across KV slots; with the single engine they serialize behind
    the busy lock (+ FIFO queue for --multiuser, 503 on overflow). An
    embedding model generates nothing: 400."""
    if getattr(state.engine, "embedding", False):
        raise web.HTTPBadRequest(
            text=json.dumps({"detail": {
                "msg": "loaded model is an embedding model (bert/t5encoder); "
                       "use /v1/embeddings",
                "type": "bad_request"}}),
            content_type="application/json")
    batched = _batched(state)
    if not batched:
        if state.busy.locked():
            if state.requests_in_queue >= max(0, state.settings.multiuser - 1):
                raise web.HTTPServiceUnavailable(
                    text=json.dumps({"detail": {
                        "msg": "Server is busy; please try again later.",
                        "type": "service_unavailable"}}),
                    content_type="application/json")
            state.requests_in_queue += 1
            try:
                await state.busy.acquire()
            finally:
                state.requests_in_queue -= 1
        else:
            await state.busy.acquire()

    genkey = str(genparams.get("genkey") or f"KCPP{uuid.uuid4().hex[:8]}")
    gen = ActiveGen(genkey=genkey, engine=state.engine)
    state.active[genkey] = gen
    try:
        if genkey in state.pending_abort_keys:
            state.pending_abort_keys.discard(genkey)
            return {"text": "", "status": 0, "stopreason": "abort"}

        params = genparams_to_engine(genparams)
        prompt = str(genparams.get("prompt", ""))
        memory = str(genparams.get("memory", "") or "")
        full_prompt = memory + prompt if memory else prompt

        loop = asyncio.get_running_loop()

        def on_token(tok, piece):
            gen.text_so_far += piece
            gen.pieces.put(piece)

        if batched:
            req = state.engine.submit(full_prompt, params, on_token,
                                      genkey=genkey)
            await loop.run_in_executor(None, req.done.wait)
            result = req.result
        else:
            result = await loop.run_in_executor(
                None, lambda: state.engine.generate(full_prompt, params,
                                                    on_token))
        gen.done = True
        gen.pieces.put(None)  # sentinel
        state.total_gens += 1
        return {"text": result.text, "status": 1, "stopreason": result.stop_reason,
                "tokens": result.tokens}
    finally:
        gen.done = True
        state.active.pop(genkey, None)
        if not batched:
            state.busy.release()


def _abort(state: ServerState, genkey: str) -> None:
    """Abort one request by genkey on the batched engine (all of them when
    genkey is empty); the single engine has one generation to abort."""
    if _batched(state):
        state.engine.abort(genkey)
    else:
        state.engine.abort()


def _wrap_response(result: dict, api_format: int, model_name: str) -> dict:
    """Per-dialect response envelope (koboldcpp.py:1444-1463)."""
    text = result.get("text", "")
    stopreason = result.get("stopreason", "length")
    finish = "stop" if stopreason in ("eos", "stop_sequence") else "length"
    now = int(time.time())
    if api_format == 1:
        return {"results": [{"text": text}]}
    if api_format == 2:
        return {"results": [{"text": text, "finish_reason": finish}]}
    if api_format == 3:
        return {"id": "cmpl-1", "object": "text_completion", "created": now,
                "model": model_name, "choices": [
                    {"index": 0, "text": text, "finish_reason": finish,
                     "logprobs": None}]}
    if api_format == 5:
        return {"caption": text.strip()}
    if api_format == 4:
        return {"id": "chatcmpl-1", "object": "chat.completion", "created": now,
                "model": model_name,
                "choices": [{"index": 0, "finish_reason": finish,
                             "message": {"role": "assistant", "content": text}}],
                "usage": {"prompt_tokens": 0, "completion_tokens": 0,
                          "total_tokens": 0}}
    return result


async def _sse_stream(state: ServerState, request: web.Request, genparams: dict,
                      api_format: int) -> web.StreamResponse:
    """SSE streaming (handle_sse_stream, koboldcpp.py:1482-1565)."""
    resp = web.StreamResponse(status=200, headers={
        "Content-Type": "text/event-stream",
        "Cache-Control": "no-cache",
        "Connection": "keep-alive",
    })
    _cors(resp)
    await resp.prepare(request)

    task = asyncio.ensure_future(_run_generation(state, genparams, api_format))
    genkey = str(genparams.get("genkey", ""))
    model_name = state.settings.model_name
    now = int(time.time())

    async def emit(piece: str, finish_reason=None):
        if api_format == 4:
            delta = {"content": piece} if piece else {}
            data = {"id": "chatcmpl-1", "object": "chat.completion.chunk",
                    "created": now, "model": model_name,
                    "choices": [{"index": 0, "finish_reason": finish_reason,
                                 "delta": delta}]}
            await resp.write(f"data: {json.dumps(data)}\n\n".encode())
        elif api_format == 3:
            data = {"id": "cmpl-1", "object": "text_completion", "created": now,
                    "model": model_name,
                    "choices": [{"index": 0, "finish_reason": finish_reason,
                                 "text": piece}]}
            await resp.write(f"data: {json.dumps(data)}\n\n".encode())
        else:  # kobold dialect
            data = {"token": piece, "finish_reason": finish_reason}
            await resp.write(f"event: message\ndata: {json.dumps(data)}\n\n".encode())

    try:
        # find the ActiveGen as soon as the generation registers
        gen = None
        for _ in range(2000):
            gen = None
            for g in state.active.values():
                if not genkey or g.genkey == genkey:
                    gen = g
                    break
            if gen is not None or task.done():
                break
            await asyncio.sleep(0.005)

        while gen is not None:
            try:
                piece = gen.pieces.get_nowait()
            except queue.Empty:
                if task.done():
                    break
                await asyncio.sleep(0.02)  # reference polls at 20ms
                continue
            if piece is None:
                break
            await emit(piece)

        result = await task
        if gen is None and result.get("text"):
            # generation completed before the poller attached (device-side
            # chunked decode can finish in one call): deliver the text as a
            # single message event rather than dropping it
            await emit(result["text"])
        finish = "stop" if result.get("stopreason") in ("eos", "stop_sequence") else "length"
        await emit("", finish_reason=finish)
        if api_format in (3, 4):
            await resp.write(b"data: [DONE]\n\n")
    except (ConnectionResetError, asyncio.CancelledError):
        # the client went away: stop the generation, then let the error out
        _abort(state, gen.genkey if gen is not None else genkey)
        if not task.done():
            await task
        raise
    await resp.write_eof()
    return resp


# ---------------------------------------------------------------------------
# routes
# ---------------------------------------------------------------------------

def make_app(engine: Engine, settings: ServerSettings | None = None) -> web.Application:
    settings = settings or ServerSettings()
    state = ServerState(engine, settings)
    app = web.Application(client_max_size=64 * 1024 * 1024)
    app[STATE] = state

    # ---- GET endpoints ----------------------------------------------------
    async def get_model(request):
        return _json({"result": settings.model_name})

    async def get_version(request):
        return _json({"result": API_VERSION, "version": API_VERSION})

    async def get_extra_version(request):
        return _json({"result": "KoboldCpp", "version": KCPP_VERSION,
                      "protected": bool(settings.password),
                      "txt2img": settings.sd_model is not None,
                      "vision": getattr(state.engine, "clip", None) is not None,
                      "transcribe": settings.whisper_model is not None,
                      "multiplayer": False})

    async def get_max_length(request):
        return _json({"value": 512})

    async def get_max_context(request):
        return _json({"value": state.engine.max_context})

    async def get_perf(request):
        t = state.engine.last_timings
        return _json({
            "last_process": t.prompt_time, "last_eval": t.gen_time,
            "last_token_count": t.gen_tokens, "last_seed": -1,
            "total_gens": state.total_gens,
            "stop_reason": -1,
            "queue": state.requests_in_queue,
            "idle": 0 if state.busy.locked() or state.active else 1,
            "hordeexitcounter": 0,
            "uptime": time.time() - state.last_req_time,
        })

    async def get_models_oai(request):
        return _json({"object": "list", "data": [
            {"id": settings.model_name, "object": "model", "created": 1,
             "owned_by": "koboldcpp", "permission": [], "root": settings.model_name}]})

    async def get_ollama_tags(request):
        return _json({"models": [{"name": settings.model_name,
                                  "model": settings.model_name,
                                  "size": 0, "digest": "0"}]})

    async def get_softprompts(request):
        return _json({"values": []})

    async def get_softprompt(request):
        return _json({"value": ""})

    async def get_preloadstory(request):
        return _json(settings.preloaded_story or {})

    def _html(text: str):
        return _cors(web.Response(text=text, content_type="text/html"))

    def _static_page(name: str) -> str | None:
        path = os.path.join(os.path.dirname(__file__), "static", name)
        try:
            with open(path, encoding="utf-8") as f:
                return f.read()
        except OSError:
            return None

    async def get_sdui(request):
        # the embedded image page (upstream serves StableUI at /sdui)
        return _html(_static_page("sdui.html")
                     or "<html><body>no UI</body></html>")

    async def get_sd_models(request):
        return _json([{"title": "stable_diffusion",
                       "model_name": "stable_diffusion", "hash": "8888888888",
                       "sha256": "", "filename": "", "config": None}])

    async def get_sd_options(request):
        return _json({"samples_format": "png",
                      "sd_model_checkpoint": "stable_diffusion"})

    async def get_sd_samplers(request):
        return _json([{"name": n, "aliases": [n], "options": {}} for n in
                      ["Euler a", "Euler", "Heun", "DPM2", "DPM++ 2S a",
                       "DPM++ 2M", "iPNDM", "iPNDM_v", "LCM"]])

    async def get_sd_upscale_modes(request):
        return _json([{"name": "None"}])

    async def get_sd_upscalers(request):
        return _json([{"name": "None", "model_name": None, "model_path": None,
                       "scale": 1}])

    async def get_root(request):
        # the embedded chat / story page (upstream serves KoboldAI Lite at /)
        return _html(
            _static_page("lite.html")
            or "<html><head><title>koboldcpp-tpu</title></head><body>"
            f"<h1>koboldcpp-tpu {KCPP_VERSION}</h1>"
            f"<p>Model: {settings.model_name}</p>"
            "<p>API docs at <a href='/api'>/api</a>. "
            "Use /noscript for a minimal chat UI.</p></body></html>")

    async def get_noscript(request):
        return _html("<html><body><h2>koboldcpp-tpu</h2>"
                     "<form method='post' action='/noscript'>"
                     "<textarea name='prompt' rows='8' cols='60'></textarea>"
                     "<br><input type='submit' value='Generate'></form>"
                     "</body></html>")

    async def get_api_docs(request):
        return _html(
            "<html><head><title>koboldcpp-tpu API</title></head><body>"
            "<h1>koboldcpp-tpu API</h1>"
            "<p>OpenAPI spec: <a href='/openapi.json'>/openapi.json</a></p>"
            "<p>KoboldAI: POST /api/v1/generate, /api/extra/generate/stream; "
            "OpenAI: /v1/completions, /v1/chat/completions; "
            "A1111: /sdapi/v1/txt2img.</p></body></html>")

    async def get_openapi(request):
        from .openapi import build_openapi_spec

        return _json(build_openapi_spec(KCPP_VERSION))

    # ---- POST endpoints ---------------------------------------------------
    def protected(handler):
        async def wrapped(request):
            if not _check_auth(state, request):
                return _json({"detail": {"error": "unauthorized",
                                         "msg": "Unauthorized"}}, status=401)
            return await handler(request)
        return wrapped

    def gen_handler(api_format: int):
        async def handler(request):
            genparams = await _read_json(request)
            transform_genparams(genparams, api_format, settings.chat_adapter)
            if genparams.get("stream", False):
                return await _sse_stream(state, request, genparams, api_format)
            result = await _run_generation(state, genparams, api_format)
            return _json(_wrap_response(result, api_format, settings.model_name))
        return protected(handler)

    async def kai_stream(request):
        genparams = await _read_json(request)
        transform_genparams(genparams, 2, settings.chat_adapter)
        return await _sse_stream(state, request, genparams, 2)

    async def tokencount(request):
        body = await _read_json(request)
        ids = state.engine.token_count(str(body.get("prompt", "")))
        return _json({"value": len(ids), "ids": ids})

    async def embeddings(request):
        """OpenAI /v1/embeddings and /api/extra/embeddings over an
        embedding model (the llama.cpp server's /embeddings role)."""
        body = await _read_json(request)
        if not getattr(state.engine, "embedding", False):
            return _json({"error": {"message":
                          "loaded model does not produce embeddings",
                          "type": "invalid_request_error"}}, status=400)
        inp = body.get("input", body.get("prompt", ""))
        texts = [str(t) for t in inp] if isinstance(inp, list) else [str(inp)]
        loop = asyncio.get_event_loop()
        vecs = await loop.run_in_executor(None, state.engine.embed, texts)
        return _json({
            "object": "list",
            "model": state.settings.model_name,
            "data": [{"object": "embedding", "index": i,
                      "embedding": [float(x) for x in v]}
                     for i, v in enumerate(vecs)],
            "usage": {"prompt_tokens": sum(len(t) for t in texts),
                      "total_tokens": sum(len(t) for t in texts)},
        })

    async def detokenize(request):
        body = await _read_json(request)
        ids = [int(i) for i in body.get("ids", [])]
        text = state.engine.tokenizer.decode(ids)
        return _json({"result": text, "success": True})

    async def abort(request):
        body = await _read_json(request)
        genkey = str(body.get("genkey", ""))
        if not genkey or genkey in state.active:
            _abort(state, genkey)
            return _json({"success": True, "done": True})
        state.pending_abort_keys.add(genkey)
        return _json({"success": True, "done": False})

    async def check(request):
        genkey = ""
        if request.method == "POST":
            body = await _read_json(request)
            genkey = str(body.get("genkey", ""))
        for g in state.active.values():
            if not genkey or g.genkey == genkey:
                return _json({"results": [{"text": g.text_so_far}]})
        return _json({"results": [{"text": ""}]})

    async def interrogate(request):
        """LLaVA caption (api_format 5; reference koboldcpp.py:1971)."""
        if getattr(state.engine, "clip", None) is None:
            return _json({"detail": {"msg": "No vision model loaded",
                                     "type": "service_unavailable"}},
                         status=503)
        body = await _read_json(request)
        genparams = transform_genparams({"images": [body.get("image", "")]},
                                        5, settings.chat_adapter)
        result = await _run_generation(state, genparams, 5)
        return _json(_wrap_response(result, 5, settings.model_name))

    async def transcribe(request):
        """Whisper (/api/extra/transcribe, /v1/audio/transcriptions; the
        reference's whisper_generate path): a base64 WAV in JSON
        `audio_data` or `file`, or a multipart `file` upload (OpenAI)."""
        if settings.whisper_model is None:
            return _json({"detail": {"msg": "No whisper model loaded",
                                     "type": "service_unavailable"}},
                         status=503)
        from ..models.whisper import decode_wav_base64

        audio_b64 = None
        if request.headers.get("Content-Type", "").startswith("multipart/"):
            import base64

            async for part in await request.multipart():
                if part.name == "file":
                    audio_b64 = base64.b64encode(await part.read()).decode()
        else:
            body = await _read_json(request)
            audio_b64 = body.get("audio_data") or body.get("file")
        if not audio_b64:
            return _json({"detail": {"msg": "missing audio_data",
                                     "type": "bad_request"}}, status=400)
        try:
            audio = decode_wav_base64(audio_b64)
        except Exception as e:  # not a WAV: the client's fault
            return _json({"detail": {"msg": f"bad audio: {e}",
                                     "type": "bad_request"}}, status=400)
        text = await asyncio.get_running_loop().run_in_executor(
            None, lambda: settings.whisper_model.transcribe(audio))
        return _json({"text": text})

    async def profiler_start(request):
        """A torch.profiler session (utils/profiling.py)."""
        from ..utils import profiling

        body = await _read_json(request)
        try:
            d = profiling.start(body.get("dir"))
        except RuntimeError as e:
            return _json({"success": False, "error": str(e)}, status=409)
        return _json({"success": True, "dir": d})

    async def profiler_stop(request):
        from ..utils import profiling

        try:
            info = profiling.stop()
        except RuntimeError as e:
            return _json({"success": False, "error": str(e)}, status=409)
        return _json({"success": True, **info})

    async def noscript_post(request):
        data = await request.post()
        prompt = str(data.get("prompt", ""))
        genparams = {"prompt": prompt, "max_length": 100}
        result = await _run_generation(state, genparams, 2)
        return _html(f"<html><body><h2>koboldcpp-tpu</h2><pre>{prompt}"
                     f"<b>{result.get('text', '')}</b></pre>"
                     "<a href='/noscript'>back</a></body></html>")

    async def options_handler(request):
        return _cors(web.Response(status=200))

    r = app.router
    for path in ("/api/v1/model", "/api/latest/model"):
        r.add_get(path, get_model)
    for path in ("/api/v1/info/version", "/api/latest/info/version"):
        r.add_get(path, get_version)
    r.add_get("/", get_root)
    r.add_get("/noscript", get_noscript)
    r.add_post("/noscript", noscript_post)
    r.add_get("/api/v1/config/max_length", get_max_length)
    r.add_get("/api/v1/config/max_context_length", get_max_context)
    r.add_get("/api/v1/config/soft_prompt", get_softprompt)
    r.add_get("/api/v1/config/soft_prompts_list", get_softprompts)
    r.add_get("/api/extra/version", get_extra_version)
    r.add_get("/api/extra/true_max_context_length", get_max_context)
    r.add_get("/api/extra/perf", get_perf)
    r.add_get("/api/extra/preloadstory", get_preloadstory)
    r.add_get("/v1/models", get_models_oai)
    r.add_get("/v1", get_api_docs)
    r.add_get("/api", get_api_docs)
    r.add_get("/docs", get_api_docs)
    r.add_get("/api/tags", get_ollama_tags)
    r.add_get("/openapi.json", get_openapi)
    r.add_get("/api/extra/json/schema", get_openapi)

    r.add_post("/request", gen_handler(1))
    r.add_post("/api/v1/generate", gen_handler(2))
    r.add_post("/api/latest/generate", gen_handler(2))
    r.add_post("/api/extra/generate/stream", kai_stream)
    r.add_post("/v1/completions", gen_handler(3))
    r.add_post("/v1/chat/completions", gen_handler(4))
    r.add_post("/api/extra/tokencount", tokencount)
    r.add_post("/api/extra/profiler/start", profiler_start)
    r.add_post("/api/extra/profiler/stop", profiler_stop)
    r.add_post("/v1/embeddings", embeddings)
    r.add_post("/api/extra/embeddings", embeddings)
    r.add_post("/api/extra/detokenize", detokenize)
    r.add_post("/api/extra/abort", abort)
    r.add_post("/api/extra/generate/check", check)
    r.add_get("/api/extra/generate/check", check)
    def _png_b64(img) -> str:
        import base64
        import io

        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()

    def _clamp_sd(width: int, height: int, steps: int) -> tuple[int, int, int]:
        """Resolution / step clamps (upstream koboldcpp.py:1120-1138;
        --sdclamped shrinks proportionally to a multiple of 64 for shared
        hosting)."""
        steps = max(1, min(80, steps))
        width, height = max(64, width), max(64, height)
        reslimit = 1024
        if settings.sd_clamped:
            steps = min(40, steps)
            reslimit = max(512, int(settings.sd_clamped))
        biggest = max(width, height)
        if biggest > reslimit:
            scaler = biggest / reslimit
            width = int(width / scaler) // 64 * 64
            height = int(height / scaler) // 64 * 64
        return width, height, steps

    def _no_sd():
        return _json({"detail": {"msg": "No SD model loaded",
                                 "type": "service_unavailable"}}, status=503)

    async def txt2img(request):
        """A1111 txt2img (upstream sd_generate)."""
        if settings.sd_model is None:
            return _no_sd()
        body = await _read_json(request)
        width, height, steps = _clamp_sd(int(body.get("width", 512)),
                                         int(body.get("height", 512)),
                                         int(body.get("steps", 20)))
        img = await asyncio.get_running_loop().run_in_executor(
            None, lambda: settings.sd_model.txt2img(
                str(body.get("prompt", "")),
                negative_prompt=str(body.get("negative_prompt", "")),
                width=width, height=height, steps=steps,
                cfg_scale=float(body.get("cfg_scale", 7.0)),
                sampler=str(body.get("sampler_name", "Euler a")),
                seed=int(body.get("seed", -1))))
        return _json({"images": [_png_b64(img)], "parameters": body,
                      "info": ""})

    async def img2img(request):
        """A1111 img2img: the first of `init_images` (base64, a data: URL
        prefix dropped) encoded by the VAE, then txt2img from part-way down
        the sigma ladder (`denoising_strength`)."""
        if settings.sd_model is None:
            return _no_sd()
        body = await _read_json(request)
        init = (body.get("init_images") or [""])[0]
        import base64
        import io

        import numpy as np
        from PIL import Image

        try:
            raw = base64.b64decode(init.split(",")[-1])
            im = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"),
                            np.uint8)
        except Exception as e:
            return _json({"detail": {"msg": f"bad init image: {e}",
                                     "type": "bad_request"}}, status=400)
        img = await asyncio.get_running_loop().run_in_executor(
            None, lambda: settings.sd_model.img2img(
                im, str(body.get("prompt", "")),
                denoise=float(body.get("denoising_strength", 0.75)),
                negative_prompt=str(body.get("negative_prompt", "")),
                steps=int(body.get("steps", 20)),
                cfg_scale=float(body.get("cfg_scale", 7.0)),
                sampler=str(body.get("sampler_name", "Euler a")),
                seed=int(body.get("seed", -1))))
        return _json({"images": [_png_b64(img)], "parameters": body,
                      "info": ""})

    r.add_get("/sdui", get_sdui)
    r.add_get("/sdapi/v1/sd-models", get_sd_models)
    r.add_get("/sdapi/v1/options", get_sd_options)
    r.add_get("/sdapi/v1/samplers", get_sd_samplers)
    r.add_get("/sdapi/v1/latent-upscale-modes", get_sd_upscale_modes)
    r.add_get("/sdapi/v1/upscalers", get_sd_upscalers)
    r.add_post("/sdapi/v1/txt2img", txt2img)
    r.add_post("/sdapi/v1/img2img", img2img)
    r.add_post("/sdapi/v1/interrogate", interrogate)
    r.add_post("/api/extra/transcribe", transcribe)
    r.add_post("/v1/audio/transcriptions", transcribe)

    # CORS preflight for everything
    r.add_route("OPTIONS", "/{tail:.*}", options_handler)
    return app


def run_server(engine: Engine, host: str = "0.0.0.0", port: int = 5001,
               settings: ServerSettings | None = None,
               ssl_pair: tuple[str, str] | None = None,
               onready: str = "", launch: bool = False):
    """ssl_pair: (cert, key) PEM paths -> HTTPS (--ssl, koboldcpp.py:
    2121-2199); onready: a shell command run once the server listens
    (--onready); launch: open the web page in a browser (--launch)."""
    app = make_app(engine, settings)
    ssl_context = None
    scheme = "http"
    if ssl_pair:
        import ssl

        ssl_context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ssl_context.load_cert_chain(ssl_pair[0], ssl_pair[1])
        scheme = "https"
    if onready or launch:
        url_host = "localhost" if host in ("0.0.0.0", "::", "") else host

        async def _on_ready(app):
            import threading

            if onready:
                import subprocess

                print(f"--onready: running: {onready}")
                threading.Thread(
                    target=lambda: subprocess.call(onready, shell=True),
                    daemon=True).start()
            if launch:
                import webbrowser

                threading.Thread(
                    target=lambda: webbrowser.open(
                        f"{scheme}://{url_host}:{port}"),
                    daemon=True).start()

        app.on_startup.append(_on_ready)
    web.run_app(app, host=host, port=port, print=None,
                ssl_context=ssl_context)
