"""Chat-template adapters.

Counterpart of the reference's kcpp_adapters/*.json (12 instruct templates)
consumed by transform_genparams (koboldcpp.py:1219). Each adapter defines the
wrapping applied to system/user/assistant turns.
"""
from __future__ import annotations

ADAPTERS: dict[str, dict[str, str]] = {
    "alpaca": {
        "system_start": "### Instruction:\n", "system_end": "\n",
        "user_start": "### Instruction:\n", "user_end": "\n",
        "assistant_start": "### Response:\n", "assistant_end": "\n",
    },
    "vicuna": {
        "system_start": "", "system_end": "\n",
        "user_start": "USER: ", "user_end": "\n",
        "assistant_start": "ASSISTANT: ", "assistant_end": "\n",
    },
    "chatml": {
        "system_start": "<|im_start|>system\n", "system_end": "<|im_end|>\n",
        "user_start": "<|im_start|>user\n", "user_end": "<|im_end|>\n",
        "assistant_start": "<|im_start|>assistant\n", "assistant_end": "<|im_end|>\n",
    },
    "llama2": {
        "system_start": "[INST] <<SYS>>\n", "system_end": "\n<</SYS>>\n",
        "user_start": "[INST] ", "user_end": " [/INST]",
        "assistant_start": " ", "assistant_end": " ",
    },
    "llama3": {
        "system_start": "<|start_header_id|>system<|end_header_id|>\n\n",
        "system_end": "<|eot_id|>",
        "user_start": "<|start_header_id|>user<|end_header_id|>\n\n",
        "user_end": "<|eot_id|>",
        "assistant_start": "<|start_header_id|>assistant<|end_header_id|>\n\n",
        "assistant_end": "<|eot_id|>",
    },
    "mistral-v1": {
        "system_start": " [INST] ", "system_end": " [/INST]",
        "user_start": " [INST] ", "user_end": " [/INST]",
        "assistant_start": " ", "assistant_end": "</s>",
    },
    "mistral-v3": {
        "system_start": "[INST] ", "system_end": "[/INST]",
        "user_start": "[INST] ", "user_end": "[/INST]",
        "assistant_start": " ", "assistant_end": "</s>",
    },
    "mistral-v3-tekken": {
        "system_start": "[INST]", "system_end": "[/INST]",
        "user_start": "[INST]", "user_end": "[/INST]",
        "assistant_start": "", "assistant_end": "</s>",
    },
    "phi3": {
        "system_start": "<|system|>\n", "system_end": "<|end|>\n",
        "user_start": "<|user|>\n", "user_end": "<|end|>\n",
        "assistant_start": "<|assistant|>\n", "assistant_end": "<|end|>\n",
    },
    "gemma2": {
        "system_start": "<start_of_turn>user\n", "system_end": "<end_of_turn>\n",
        "user_start": "<start_of_turn>user\n", "user_end": "<end_of_turn>\n",
        "assistant_start": "<start_of_turn>model\n", "assistant_end": "<end_of_turn>\n",
    },
    "command-r": {
        "system_start": "<|START_OF_TURN_TOKEN|><|SYSTEM_TOKEN|>",
        "system_end": "<|END_OF_TURN_TOKEN|>",
        "user_start": "<|START_OF_TURN_TOKEN|><|USER_TOKEN|>",
        "user_end": "<|END_OF_TURN_TOKEN|>",
        "assistant_start": "<|START_OF_TURN_TOKEN|><|CHATBOT_TOKEN|>",
        "assistant_end": "<|END_OF_TURN_TOKEN|>",
    },
    "metharme": {
        "system_start": "<|system|>", "system_end": "",
        "user_start": "<|user|>", "user_end": "",
        "assistant_start": "<|model|>", "assistant_end": "",
    },
}


# name-substring rules checked in order (first match wins) — the reference's
# AutoGuess-style adapter selection, from the model's general.name/filename
_NAME_RULES: tuple[tuple[str, str], ...] = (
    ("llama-3", "llama3"), ("llama3", "llama3"),
    ("llama-2", "llama2"), ("llama2", "llama2"),
    ("tekken", "mistral-v3-tekken"), ("nemo", "mistral-v3-tekken"),
    ("mistral", "mistral-v3"), ("mixtral", "mistral-v1"),
    ("gemma-2", "gemma2"), ("gemma2", "gemma2"), ("gemma", "gemma2"),
    ("phi-3", "phi3"), ("phi3", "phi3"),
    ("command-r", "command-r"), ("c4ai", "command-r"),
    ("vicuna", "vicuna"), ("wizard", "vicuna"),
    ("alpaca", "alpaca"),
    ("metharme", "metharme"), ("pygmalion", "metharme"),
    ("qwen", "chatml"), ("yi-", "chatml"), ("hermes", "chatml"),
    ("chatml", "chatml"),
)

# special-token fingerprints: if the tokenizer VOCABULARY contains the
# template's control tokens, the model was trained with that template —
# stronger evidence than the name, so these are checked first
_TOKEN_RULES: tuple[tuple[str, str], ...] = (
    ("<|start_header_id|>", "llama3"),
    ("<|im_start|>", "chatml"),
    ("<start_of_turn>", "gemma2"),
    ("<|SYSTEM_TOKEN|>", "command-r"),
    ("<|model|>", "metharme"),   # before phi3: both vocabs carry <|system|>
    ("<|end|>", "phi3"),
)


def guess_adapter(model_name: str = "",
                  vocab_tokens=None) -> str | None:
    """Pick an instruct adapter for a model: tokenizer control-token
    fingerprints first, then name substrings (AutoGuess-style; the reference
    ships this as adapter JSON name matching). Returns an ADAPTERS key or
    None when nothing matches."""
    if vocab_tokens is not None:
        vocab = set(vocab_tokens) if not isinstance(vocab_tokens, set) \
            else vocab_tokens
        for tok, key in _TOKEN_RULES:
            if tok in vocab:
                return key
    name = (model_name or "").lower()
    for sub, key in _NAME_RULES:
        if sub in name:
            return key
    return None


def apply_chat_template(messages: list[dict], adapter: dict[str, str] | None = None,
                        add_generation_prompt: bool = True) -> str:
    """Render OpenAI-style messages into a prompt string."""
    a = adapter or ADAPTERS["chatml"]
    out = []
    for m in messages:
        role = m.get("role", "user")
        content = m.get("content", "")
        if isinstance(content, list):  # multimodal parts
            content = "".join(p.get("text", "") for p in content
                              if isinstance(p, dict) and p.get("type") == "text")
        key = {"system": "system", "user": "user", "assistant": "assistant",
               "tool": "user"}.get(role, "user")
        out.append(a[f"{key}_start"] + str(content) + a[f"{key}_end"])
    if add_generation_prompt:
        out.append(a["assistant_start"])
    return "".join(out)
