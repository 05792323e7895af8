"""HTTP API server: the text endpoints.

Port of koboldcpp_tpu/server/app.py for text generation: KoboldAI
`/api/v1/*` + `/api/extra/*`, OpenAI `/v1/completions` and
`/v1/chat/completions`, SSE token streaming in both dialects, Bearer auth,
CORS, genkey-based polling/abort. The image, audio and
embeddings endpoints are not ported yet.

asyncio (aiohttp) frontend; generation runs in a worker thread around the
blocking engine, one generation at a time: a request that arrives while
another runs gets 503 (single user; the JAX launcher's --multiuser batching
is not ported yet).
"""
from __future__ import annotations

import asyncio
import json
import queue
import time
import uuid
from dataclasses import dataclass, field

from aiohttp import web

from ..engine import Engine
from .dialects import genparams_to_engine, transform_genparams

KCPP_VERSION = "1.0.0-torch"
API_VERSION = "1.2.2"


@dataclass
class ServerSettings:
    password: str = ""
    model_name: str = "koboldcpp-tpu-torch/model"


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

async def _run_generation(state: ServerState, genparams: dict,
                          api_format: int) -> dict:
    """Run one generation under the busy lock; 503 while another runs."""
    if state.busy.locked():
        raise web.HTTPServiceUnavailable(
            text=json.dumps({"detail": {"msg": "Server is busy; please try again later.",
                                        "type": "service_unavailable"}}),
            content_type="application/json")
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

        result = await loop.run_in_executor(
            None, lambda: state.engine.generate(full_prompt, params, on_token))
        gen.done = True
        gen.pieces.put(None)  # sentinel
        state.total_gens += 1
        return {"text": result.text, "status": 1, "stopreason": result.stop_reason,
                "tokens": result.tokens}
    finally:
        gen.done = True
        state.active.pop(genkey, None)
        state.busy.release()


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
        state.engine.abort()
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
                      "txt2img": False, "vision": False,
                      "transcribe": False, "multiplayer": False})

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
            "queue": 0,
            "idle": 0 if state.busy.locked() else 1,
            "hordeexitcounter": 0,
            "uptime": time.time() - state.last_req_time,
        })

    async def get_models_oai(request):
        return _json({"object": "list", "data": [
            {"id": settings.model_name, "object": "model", "created": 1,
             "owned_by": "koboldcpp", "permission": [], "root": settings.model_name}]})

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
            transform_genparams(genparams, api_format)
            if genparams.get("stream", False):
                return await _sse_stream(state, request, genparams, api_format)
            result = await _run_generation(state, genparams, api_format)
            return _json(_wrap_response(result, api_format, settings.model_name))
        return protected(handler)

    async def kai_stream(request):
        genparams = await _read_json(request)
        transform_genparams(genparams, 2)
        return await _sse_stream(state, request, genparams, 2)

    async def tokencount(request):
        body = await _read_json(request)
        ids = state.engine.token_count(str(body.get("prompt", "")))
        return _json({"value": len(ids), "ids": ids})

    async def detokenize(request):
        body = await _read_json(request)
        ids = [int(i) for i in body.get("ids", [])]
        text = state.engine.tokenizer.decode(ids)
        return _json({"result": text, "success": True})

    async def abort(request):
        body = await _read_json(request)
        genkey = str(body.get("genkey", ""))
        if not genkey or genkey in state.active:
            state.engine.abort()
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

    async def options_handler(request):
        return _cors(web.Response(status=200))

    r = app.router
    for path in ("/api/v1/model", "/api/latest/model"):
        r.add_get(path, get_model)
    for path in ("/api/v1/info/version", "/api/latest/info/version"):
        r.add_get(path, get_version)
    r.add_get("/api/v1/config/max_length", get_max_length)
    r.add_get("/api/v1/config/max_context_length", get_max_context)
    r.add_get("/api/extra/version", get_extra_version)
    r.add_get("/api/extra/true_max_context_length", get_max_context)
    r.add_get("/api/extra/perf", get_perf)
    r.add_get("/v1/models", get_models_oai)
    r.add_get("/openapi.json", get_openapi)
    r.add_get("/api/extra/json/schema", get_openapi)

    r.add_post("/request", gen_handler(1))
    r.add_post("/api/v1/generate", gen_handler(2))
    r.add_post("/api/latest/generate", gen_handler(2))
    r.add_post("/api/extra/generate/stream", kai_stream)
    r.add_post("/v1/completions", gen_handler(3))
    r.add_post("/v1/chat/completions", gen_handler(4))
    r.add_post("/api/extra/tokencount", tokencount)
    r.add_post("/api/extra/detokenize", detokenize)
    r.add_post("/api/extra/abort", abort)
    r.add_post("/api/extra/generate/check", check)
    r.add_get("/api/extra/generate/check", check)

    # CORS preflight for everything
    r.add_route("OPTIONS", "/{tail:.*}", options_handler)
    return app


def run_server(engine: Engine, host: str = "0.0.0.0", port: int = 5001,
               settings: ServerSettings | None = None):
    web.run_app(make_app(engine, settings), host=host, port=port, print=None)
