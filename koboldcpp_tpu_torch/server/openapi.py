"""OpenAPI spec for the HTTP surface (served at /api and /docs/openapi.json).

Counterpart of the reference's embedded SwaggerUI spec
(kcpp_docs.embd:409-913) — generated from the live route table instead of a
baked blob.
"""
from __future__ import annotations


def _gen_params_schema() -> dict:
    return {
        "type": "object",
        "properties": {
            "prompt": {"type": "string"},
            "memory": {"type": "string"},
            "max_length": {"type": "integer", "default": 100},
            "max_context_length": {"type": "integer"},
            "temperature": {"type": "number", "default": 0.7},
            "top_k": {"type": "integer", "default": 100},
            "top_a": {"type": "number", "default": 0},
            "top_p": {"type": "number", "default": 0.92},
            "min_p": {"type": "number", "default": 0},
            "typical": {"type": "number", "default": 1},
            "tfs": {"type": "number", "default": 1},
            "rep_pen": {"type": "number", "default": 1.1},
            "rep_pen_range": {"type": "integer", "default": 320},
            "rep_pen_slope": {"type": "number", "default": 1},
            "presence_penalty": {"type": "number", "default": 0},
            "mirostat": {"type": "integer", "enum": [0, 1, 2]},
            "mirostat_tau": {"type": "number"},
            "mirostat_eta": {"type": "number"},
            "dry_multiplier": {"type": "number"},
            "dry_base": {"type": "number"},
            "dry_allowed_length": {"type": "integer"},
            "dry_sequence_breakers": {"type": "array", "items": {"type": "string"}},
            "xtc_threshold": {"type": "number"},
            "xtc_probability": {"type": "number"},
            "dynatemp_range": {"type": "number"},
            "dynatemp_exponent": {"type": "number"},
            "smoothing_factor": {"type": "number"},
            "sampler_order": {"type": "array", "items": {"type": "integer"}},
            "sampler_seed": {"type": "integer"},
            "stop_sequence": {"type": "array", "items": {"type": "string"}},
            "logit_bias": {"type": "object"},
            "banned_tokens": {"type": "array", "items": {"type": "integer"}},
            "banned_strings": {"type": "array", "items": {"type": "string"}},
            "grammar": {"type": "string", "description": "GBNF grammar"},
            "grammar_retain_state": {"type": "boolean"},
            "use_default_badwordsids": {"type": "boolean"},
            "bypass_eos": {"type": "boolean"},
            "trim_stop": {"type": "boolean"},
            "images": {"type": "array", "items": {"type": "string"},
                       "description": "base64 images (LLaVA)"},
            "genkey": {"type": "string"},
            "stream": {"type": "boolean"},
        },
        "required": ["prompt"],
    }


def build_openapi_spec(version: str) -> dict:
    gen = _gen_params_schema()
    txt_resp = {"200": {"description": "OK", "content": {"application/json": {
        "schema": {"type": "object", "properties": {
            "results": {"type": "array", "items": {"type": "object", "properties": {
                "text": {"type": "string"}}}}}}}}}}

    def post(summary, body_schema=None, responses=None):
        op = {"summary": summary, "responses": responses or txt_resp}
        if body_schema:
            op["requestBody"] = {"content": {"application/json": {
                "schema": body_schema}}}
        return {"post": op}

    def get(summary):
        return {"get": {"summary": summary,
                        "responses": {"200": {"description": "OK"}}}}

    paths = {
        "/api/v1/generate": post("KoboldAI generate (blocking)", gen),
        "/api/extra/generate/stream": post("KoboldAI generate (SSE stream)", gen),
        "/api/extra/generate/check": post(
            "Poll partial output by genkey",
            {"type": "object", "properties": {"genkey": {"type": "string"}}}),
        "/api/extra/abort": post(
            "Abort a generation",
            {"type": "object", "properties": {"genkey": {"type": "string"}}}),
        "/api/extra/tokencount": post(
            "Tokenize and count",
            {"type": "object", "properties": {"prompt": {"type": "string"}}}),
        "/api/extra/detokenize": post(
            "Detokenize ids",
            {"type": "object", "properties": {
                "ids": {"type": "array", "items": {"type": "integer"}}}}),
        "/api/extra/transcribe": post(
            "Whisper transcription (base64 wav)",
            {"type": "object", "properties": {"audio_data": {"type": "string"}}}),
        "/v1/completions": post("OpenAI completions (+SSE)"),
        "/v1/chat/completions": post("OpenAI chat completions (+SSE, tools, images)"),
        "/v1/audio/transcriptions": post("OpenAI audio transcription"),
        "/sdapi/v1/txt2img": post("A1111 txt2img"),
        "/sdapi/v1/img2img": post("A1111 img2img"),
        "/sdapi/v1/interrogate": post("LLaVA image caption"),
        "/api/v1/model": get("Current model name"),
        "/api/v1/info/version": get("KoboldAI API version"),
        "/api/extra/version": get("Server version + feature flags"),
        "/api/extra/perf": get("Last-generation timings and queue state"),
        "/api/extra/true_max_context_length": get("Configured context length"),
        "/api/v1/config/max_context_length": get("Max context length"),
        "/api/v1/config/max_length": get("Default max generation length"),
        "/api/extra/preloadstory": get("Preloaded story JSON"),
        "/v1/models": get("OpenAI model list"),
        "/api/tags": get("ollama-compatible model tags"),
        "/sdapi/v1/sd-models": get("A1111 model list"),
        "/sdapi/v1/samplers": get("A1111 sampler list"),
    }
    return {
        "openapi": "3.0.3",
        "info": {"title": "koboldcpp-tpu API",
                 "description": "KoboldAI + OpenAI + A1111-compatible API",
                 "version": version},
        "paths": paths,
    }
