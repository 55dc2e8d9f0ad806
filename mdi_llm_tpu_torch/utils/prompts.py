"""Prompt styles, stop-token sequences, and multi-prompt loading.

Copy of `mdi_llm_tpu/utils/prompts.py`: the chat/instruct formats with
per-style stop-token sequences, dispatch from the model name
(`style_for_model`), `prompt_style.yaml` persistence next to checkpoints,
and the `FILE:`-prefixed multi-prompt loader (`get_user_prompt`).

A style is a small dataclass holding a `template` callable and a `stop`
callable, so the registry is data.  The template strings are the public
litGPT/vendor chat formats, which instruct checkpoints expect.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from mdi_llm_tpu_torch.utils.tokenizer import Tokenizer

StopFn = Callable[[Tokenizer], Tuple[List[int], ...]]


def _eos_only(tok: Tokenizer) -> Tuple[List[int], ...]:
    return ([tok.eos_id],)


def _ids(tok: Tokenizer, *names, missing_ok=True) -> List[int]:
    out = []
    for n in names:
        i = tok.token_to_id(n, missing_ok=missing_ok) if isinstance(n, str) else n
        if i is None:
            return []
        out.append(i)
    return out


@dataclass
class PromptStyle:
    name: str
    template: Callable[[str], str]
    stop: StopFn = _eos_only

    def apply(self, prompt: str, **kwargs: str) -> str:
        return self.template(prompt)

    def stop_tokens(self, tokenizer: Tokenizer) -> Tuple[List[int], ...]:
        return tuple(s for s in self.stop(tokenizer) if s and s[0] is not None)

    @classmethod
    def from_name(cls, name: str) -> "PromptStyle":
        return styles[name]

    @classmethod
    def from_config(cls, config) -> "PromptStyle":
        return style_for_model(config.name)


def _alpaca(p: str) -> str:
    return (
        "Below is an instruction that describes a task. "
        "Write a response that appropriately completes the request.\n\n"
        f"### Instruction:\n{p}\n\n### Response:\n"
    )


def _llama2(p: str) -> str:
    sys_prompt = (
        "You are a helpful, respectful and honest assistant. Always answer as helpfully as"
        " possible, while being safe.  Your answers should not include any harmful, unethical, racist, sexist,"
        " toxic, dangerous, or illegal content. Please ensure that your responses are socially unbiased and"
        " positive in nature.\n\nIf a question does not make any sense, or is not factually coherent, explain why"
        " instead of answering something not correct. If you don't know the answer to a question, please don't"
        " share false information."
    )
    return f"[INST] <<SYS>>\n{sys_prompt}\n<</SYS>>\n\n {p} [/INST] "


def _llama3(p: str) -> str:
    # Meta's llama3 chat format (public spec)
    return (
        "<|begin_of_text|><|start_header_id|>system<|end_header_id|>\n\n"
        "You are a helpful assistant.<|eot_id|>\n"
        "<|start_header_id|>user<|end_header_id|>\n\n"
        f"{p}<|eot_id|>\n"
        "<|start_header_id|>assistant<|end_header_id|>\n\n"
    )


def _stablelm_alpha(p: str) -> str:
    return (
        "<|SYSTEM|># StableLM Tuned (Alpha version)\n- StableLM is a helpful and harmless open-source AI language"
        " model developed by StabilityAI.\n- StableLM is excited to be able to help the user, but will refuse to do"
        " anything that could be considered harmful to the user.\n- StableLM is more than just an information"
        " source, StableLM is also able to write poetry, short stories, and make jokes.\n- StableLM will refuse to"
        f" participate in anything that could harm a human.<|USER|>{p}<|ASSISTANT|>"
    )


def _tinyllama(p: str) -> str:
    return (
        "<|system|>\n"
        "You are a friendly chatbot who always gives helpful, detailed, and polite answers.</s>\n"
        "<|user|>\n"
        f"{p}</s>\n"
        "<|assistant|>\n"
    )


def _llama2_fc(p: str) -> str:
    # Trelis function-calling v2 format: functions block + INST/SYS wrapper
    function_metadata = {
        "function": "search_bing",
        "description": (
            "Search the web for content on Bing. This allows users to search online/the internet/the web for"
            " content."
        ),
        "arguments": [
            {"name": "query", "type": "string", "description": "The search query string"}
        ],
    }
    system_prompt = (
        "You are a helpful, respectful and honest assistant. Always answer as helpfully as"
        "possible. Your only response should be JSON formatted functions"
    )
    fn_list = json.dumps(function_metadata).replace("{", "{{").replace("}", "}}")
    return (
        f"<FUNCTIONS>{fn_list.strip()}</FUNCTIONS>\n\n"
        f"[INST]<<SYS>>\n{system_prompt.strip()}\n<</SYS>>\n\n{p}[/INST]\n\n"
    )


styles: Dict[str, PromptStyle] = {}


def _register(name: str, template: Callable[[str], str], stop: StopFn = _eos_only):
    styles[name] = PromptStyle(name, template, stop)


_register("default", lambda p: p)
_register("alpaca", _alpaca)
_register("flan", _alpaca)
_register("longform", _alpaca)
_register(
    "stablelm-alpha",
    _stablelm_alpha,
    lambda t: (
        [t.eos_id],
        _ids(t, "<|SYSTEM|>"),
        _ids(t, "<|ASSISTANT|>"),
        _ids(t, "<|USER|>"),
    ),
)
_register("stablelm-zephyr", lambda p: f"<|user|>\n{p}<|endoftext|>\n<|assistant|>\n")
_register(
    "togethercomputer-chat",
    lambda p: f"<human>: {p}\n<bot>:",
    lambda t: (
        [t.eos_id],
        _ids(t, "<", "human", ">:"),
        _ids(t, "<", "bot", ">:"),
    ),
)
_register(
    "togethercomputer-instruct",
    lambda p: f"Q: {p}\nA:",
    lambda t: (
        [t.eos_id],
        _ids(t, "Q", ":"),
        _ids(t, "Question"),
        _ids(t, "A", ":"),
        _ids(t, "Label", ":"),
        [187, 187],
        [535],
        [2756],
    ),
)
_register(
    "falcon",
    lambda p: f"Do not prefix your replies with 'Bot: '\nUser: {p}\n",
    lambda t: ([t.eos_id], _ids(t, "User", ":"), _ids(t, 193, "User")),
)
_register(
    "vicuna",
    lambda p: (
        "A chat between a curious user and an artificial intelligence assistant. The assistant gives helpful, "
        f"detailed, and polite answers to the user's questions. USER: {p} ASSISTANT:"
    ),
)
_register("llama2-function-calling", _llama2_fc)
_register("llama2", _llama2)
_register(
    "llama3",
    _llama3,
    lambda t: ([t.eos_id], _ids(t, "<|eot_id|>")),
)
_register(
    "freewilly2",
    lambda p: (
        "### System:\nThis is a system prompt, please behave and help the user.\n\n"
        f"### User:\n{p}\n\n### Assistant:\n"
    ),
)
_register("platypus", lambda p: f"### Instruction:\n\n{p}\n\n### Response:\n")
_register("nous-research", lambda p: f"### Instruction:\n{p}\n\n### Response:\n")
_register("stablecode", lambda p: f"###Instruction\n{p}###Response\n")
_register("codellama", lambda p: f"<s>[INST] {p} [/INST]")
_register(
    "phi-1",
    lambda p: f"{p}\n\nAnswer:",
    lambda t: ([t.eos_id], _ids(t, "Answer", ":"), _ids(t, 198, "Answer", ":")),
)
_register("phi-2", lambda p: f"Instruct: {p}\nOutput:")
_register("tinyllama", _tinyllama)
_register("gemma", lambda p: f"<start_of_turn>user\n{p}<end_of_turn>\n<start_of_turn>model\n")
_register("h2oai", lambda p: f"<|prompt|>{p}</s><|answer|>")
# generation starts from a bare newline (reference `NoPrompt`)
_register("no-prompt", lambda p: "\n")


# (pattern, style) dispatch — mirrors reference
# `model_name_to_prompt_style` (prompts.py:325-366)
_MODEL_STYLE_RULES: Sequence[Tuple[str, str]] = (
    (r"stablelm-tuned-alpha", "stablelm-alpha"),
    (r"stablelm-zephyr-3b", "stablelm-zephyr"),
    (r"stablecode-instruct", "stablecode"),
    (r"RedPajama-INCITE.*-Chat", "togethercomputer-chat"),
    (r"RedPajama-INCITE.*-Instruct", "togethercomputer-instruct"),
    (r"falcon.*-instruct", "falcon"),
    (r"vicuna|longchat", "vicuna"),
    (r"Llama-2-7b-chat-hf-function-calling-v2", "llama2-function-calling"),
    (r"Llama-2.*-chat", "llama2"),
    (r"Llama-3.*-Instruct", "llama3"),
    (r"FreeWilly2", "freewilly2"),
    (r"Platypus", "platypus"),
    (r"Nous-Hermes", "nous-research"),
    (r"CodeLlama|Mistral.*Instruct", "codellama"),
    (r"phi-1", "phi-1"),
    (r"phi-2", "phi-2"),
    (r"tiny-llama.*chat|TinyLlama.*Chat", "tinyllama"),
    (r"(Code)?Gemma.*-it", "gemma"),
    (r"Danube2.*-chat", "h2oai"),
    (r"(?i)nanollama", "no-prompt"),
)


def style_for_model(model_name: str) -> PromptStyle:
    for pattern, style in _MODEL_STYLE_RULES:
        if re.search(pattern, model_name):
            return styles[style]
    return styles["default"]


# -- persistence (≡ reference save/load/has_prompt_style, prompts.py:369-389)


def save_prompt_style(style: Union[str, PromptStyle], checkpoint_dir: Union[str, Path]) -> None:
    name = style if isinstance(style, str) else style.name
    if name not in styles:
        raise ValueError(f"unknown prompt style {name!r}")
    p = Path(checkpoint_dir)
    p.mkdir(parents=True, exist_ok=True)
    (p / "prompt_style.yaml").write_text(f"style: {json.dumps(name)}\n")


def load_prompt_style(checkpoint_dir: Union[str, Path]) -> PromptStyle:
    text = (Path(checkpoint_dir) / "prompt_style.yaml").read_text()
    m = re.search(r"style:\s*\"?([\w.-]+)\"?", text)
    if not m:
        raise ValueError(f"malformed prompt_style.yaml in {checkpoint_dir}")
    return styles[m.group(1)]


def has_prompt_style(checkpoint_dir: Union[str, Path]) -> bool:
    return (Path(checkpoint_dir) / "prompt_style.yaml").is_file()


# -- multi-prompt loading (≡ reference get_user_prompt, prompts.py:392-447) --


def get_user_prompt(prompt: str, n_samples: int, custom_style: Optional[PromptStyle] = None) -> List[str]:
    """Resolve `prompt` into exactly `n_samples` prompt strings.

    `FILE:<path>` loads a text file with one prompt per blank-line-separated
    paragraph; fewer paragraphs than samples → cycle; more → truncate
    (reference semantics, prompts.py:392-447).
    """
    if prompt.startswith("FILE:"):
        path = Path(prompt[len("FILE:") :])
        text = path.read_text()
        paragraphs = [p.strip() for p in re.split(r"\n\s*\n", text) if p.strip()]
        if not paragraphs:
            raise ValueError(f"prompt file {path} is empty")
    else:
        paragraphs = [prompt]
    out = [paragraphs[i % len(paragraphs)] for i in range(n_samples)]
    if custom_style is not None:
        out = [custom_style.apply(p) for p in out]
    return out
