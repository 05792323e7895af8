"""API dialect normalization.

Counterpart of transform_genparams (koboldcpp.py:1219-1371):
translates the 5 supported request formats into one kobold genparams dict:
  1 = basic/proxy, 2 = KoboldAI, 3 = OpenAI completions, 4 = OpenAI chat,
  5 = interrogate. Also maps genparams -> engine GenParams + SamplerParams.
"""
from __future__ import annotations

import json
from typing import Any

from ..engine import GenParams
from ..sampling import SamplerParams
from .adapters import ADAPTERS, apply_chat_template

# a permissive JSON grammar used when OpenAI tool-calling forces JSON output
# (reference forces a json GBNF at koboldcpp.py:1315-1340)
JSON_GBNF = r'''
root ::= object
value ::= object | array | string | number | ("true" | "false" | "null") ws
object ::= "{" ws ( string ":" ws value ("," ws string ":" ws value)* )? "}" ws
array ::= "[" ws ( value ("," ws value)* )? "]" ws
string ::= "\"" ( [^"\\\x7F\x00-\x1F] | "\\" (["\\bfnrt] | "u" [0-9a-fA-F]{4}) )* "\"" ws
number ::= ("-"? ([0-9] | [1-9] [0-9]*)) ("." [0-9]+)? ([eE] [-+]? [0-9]+)? ws
ws ::= [ \t\n]*
'''


def _tools_grammar(tools: list, tool_choice) -> str:
    """Schema-constrained tool-call grammar: anyOf over each function's
    {"name": const, "arguments": <parameters schema>}; falls back to the
    generic JSON grammar if schema conversion fails."""
    from ..grammar.json_schema import json_schema_to_gbnf

    try:
        forced_name = None
        if isinstance(tool_choice, dict):
            forced_name = (tool_choice.get("function") or {}).get("name")
        alts = []
        for t in tools:
            fn = t.get("function", t)
            name = fn.get("name", "")
            if forced_name and name != forced_name:
                continue
            params = fn.get("parameters") or {"type": "object"}
            alts.append({"type": "object",
                         "properties": {"name": {"const": name},
                                        "arguments": params},
                         "required": ["name", "arguments"]})
        if not alts:
            return JSON_GBNF
        schema = alts[0] if len(alts) == 1 else {"anyOf": alts}
        return json_schema_to_gbnf(schema)
    except Exception:
        return JSON_GBNF


def transform_genparams(genparams: dict, api_format: int,
                        chat_adapter: str | dict | None = None) -> dict:
    """Normalize a request body into kobold genparams (in place + returned)."""
    if api_format == 1:  # basic proxy
        genparams["max_length"] = genparams.get("max", genparams.get("max_length", 100))
        genparams["sampler_seed"] = genparams.get("seed", -1)

    elif api_format in (3, 4):  # OpenAI
        genparams["max_length"] = genparams.get("max_tokens",
                                                genparams.get("max_completion_tokens", 100))
        genparams["sampler_seed"] = genparams.get("seed", -1)
        if "presence_penalty" in genparams:
            genparams["presence_penalty"] = genparams["presence_penalty"]
        if "frequency_penalty" in genparams and "rep_pen" not in genparams:
            # loose mapping, same spirit as the reference
            genparams["rep_pen"] = 1.0 + max(0.0, float(genparams["frequency_penalty"])) * 0.1
        stop = genparams.get("stop")
        if stop:
            genparams["stop_sequence"] = [stop] if isinstance(stop, str) else list(stop)
        genparams.setdefault("temperature", genparams.get("temperature", 1.0))
        if "top_p" in genparams:
            genparams["top_p"] = genparams["top_p"]
        if "logit_bias" in genparams and isinstance(genparams["logit_bias"], dict):
            genparams["logit_bias"] = {int(k): float(v)
                                       for k, v in genparams["logit_bias"].items()}

    if api_format == 3:
        genparams["prompt"] = genparams.get("prompt", "")

    if api_format == 4:  # OpenAI chat -> prompt via template
        adapter = None
        if isinstance(chat_adapter, dict):
            adapter = chat_adapter
        elif isinstance(chat_adapter, str) and chat_adapter in ADAPTERS:
            adapter = ADAPTERS[chat_adapter]
        messages = genparams.get("messages", [])
        # extract image parts (OpenAI image_url -> kobold images list,
        # reference koboldcpp.py image_url extraction)
        images = list(genparams.get("images", []))
        for m in messages:
            content = m.get("content")
            if isinstance(content, list):
                for part in content:
                    if isinstance(part, dict) and part.get("type") == "image_url":
                        url = (part.get("image_url") or {}).get("url", "")
                        if url.startswith("data:"):
                            images.append(url.split(",", 1)[-1])
        if images:
            genparams["images"] = images
        tools = genparams.get("tools") or []
        tool_choice = genparams.get("tool_choice", "auto")
        if tools and tool_choice != "none":
            # inject tool specs and force JSON output (reference :1315-1340),
            # schema-constrained per tool when parameters are declared
            tool_text = json.dumps(tools, indent=1)
            instr = ("\nYou have access to the following functions/tools. "
                     "To use one, respond ONLY with a JSON object of the form "
                     '{"name": <function-name>, "arguments": <args-dict>}.\n'
                     f"Available tools:\n{tool_text}\n")
            messages = list(messages) + [{"role": "system", "content": instr}]
            genparams["grammar"] = _tools_grammar(tools, tool_choice)
            genparams["using_openai_tools"] = True
        genparams["prompt"] = apply_chat_template(messages, adapter)

    if api_format == 5:  # interrogate (LLaVA caption)
        genparams["prompt"] = ("### Instruction: In one sentence, write a descriptive "
                               "caption for this image.\n### Response:")
        genparams["max_length"] = genparams.get("max_length", 150)

    return genparams


def genparams_to_engine(genparams: dict) -> GenParams:
    """kobold genparams dict -> engine GenParams (generate(), koboldcpp.py:868)."""
    def g(key, default):
        v = genparams.get(key, default)
        return default if v is None else v

    order = g("sampler_order", [6, 0, 1, 3, 4, 2, 5])
    sampler = SamplerParams(
        temperature=float(g("temperature", 0.7)),
        top_k=int(g("top_k", 100)),
        top_a=float(g("top_a", 0.0)),
        top_p=float(g("top_p", 0.92)),
        min_p=float(g("min_p", 0.0)),
        typical_p=float(g("typical", g("typical_p", 1.0))),
        tfs=float(g("tfs", 1.0)),
        rep_pen=float(g("rep_pen", 1.1)),
        rep_pen_range=int(g("rep_pen_range", 320)),
        rep_pen_slope=float(g("rep_pen_slope", 1.0)),
        presence_penalty=float(g("presence_penalty", 0.0)),
        mirostat=int(g("mirostat", 0)),
        mirostat_tau=float(g("mirostat_tau", 5.0)),
        mirostat_eta=float(g("mirostat_eta", 0.1)),
        dry_multiplier=float(g("dry_multiplier", 0.0)),
        dry_base=float(g("dry_base", 1.75)),
        dry_allowed_length=int(g("dry_allowed_length", 2)),
        dry_penalty_last_n=int(g("dry_penalty_last_n", 0)),
        xtc_threshold=float(g("xtc_threshold", 0.2)),
        xtc_probability=float(g("xtc_probability", 0.0)),
        dynatemp_range=float(g("dynatemp_range", 0.0)),
        dynatemp_exponent=float(g("dynatemp_exponent", 1.0)),
        smoothing_factor=float(g("smoothing_factor", 0.0)),
        sampler_order=tuple(order),
        logit_biases={int(k): float(v)
                      for k, v in (g("logit_bias", {}) or {}).items()},
        banned_tokens=tuple(int(t) for t in g("banned_tokens", [])
                            if isinstance(t, (int, float))),
        seed=int(g("sampler_seed", -1)),
    )
    return GenParams(
        max_length=int(g("max_length", 100)),
        sampler=sampler,
        stop_sequences=[str(s) for s in g("stop_sequence", [])][:32],
        grammar=str(g("grammar", "")),
        grammar_retain_state=bool(g("grammar_retain_state", False)),
        use_default_badwordsids=bool(g("use_default_badwordsids", False)),
        banned_phrases=[str(s) for s in g("banned_strings", [])][:48],
        dry_sequence_breakers=[str(s) for s in g("dry_sequence_breakers", [])][:24],
        trim_stop=bool(g("trim_stop", True)),
        bypass_eos=bool(g("bypass_eos", False)),
        images=[str(i) for i in g("images", [])][:4],
    )
