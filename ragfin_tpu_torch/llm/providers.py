"""Multi-LLM provider layer (C13).

Capability parity with the reference's provider stack
(``graph_rag_mcp/providers/llm_providers.py``): an abstract async
``LLMProvider.generate_content(prompt) -> str`` with per-instance rate
limiting, concrete providers for Gemini / OpenAI-compatible / Groq / Ollama,
and a ``ModelFactory``. Differences by design:

- No vendor SDKs (none are installed in this image): every provider speaks
  the public REST API directly over ``httpx``.
- A first-class :class:`FakeProvider` (deterministic, in-process) — the
  reference's ABC makes this trivial and SURVEY.md §4 calls for it as the
  test seam for every LLM-dependent path.
- Failures raise :class:`ProviderError` with the HTTP detail rather than a
  bare Exception.
"""

from __future__ import annotations

import asyncio
import json
import re
import time
from abc import ABC, abstractmethod
from typing import Awaitable, Callable, Optional, Union

from ..config.constants import SUPPORTED_MODELS


class ProviderError(RuntimeError):
    pass


class RateLimiter:
    """Min-interval limiter (reference semantics: sleep the remainder).

    Serialized with an asyncio.Lock: without it, N concurrent tasks all
    read the same ``last_call``, sleep the same remainder, and fire
    simultaneously — exactly the burst the limiter exists to prevent.
    Sleeping INSIDE the lock is intentional (waiters queue up and release
    ``delay`` apart). The lock is created lazily so the limiter can be
    constructed outside any event loop."""

    def __init__(self, delay: float = 4.0):
        self.delay = delay
        self.last_call = 0.0
        self._lock: Optional[asyncio.Lock] = None

    async def wait(self) -> None:
        if self._lock is None:
            self._lock = asyncio.Lock()
        async with self._lock:
            elapsed = time.time() - self.last_call
            if elapsed < self.delay:
                await asyncio.sleep(self.delay - elapsed)
            self.last_call = time.time()


class LLMProvider(ABC):
    def __init__(
        self,
        model_name: str,
        api_key: Optional[str] = None,
        rate_limit: float = 1.0,
        timeout: float = 60.0,
    ):
        self.model_name = model_name
        self.api_key = api_key
        self.limiter = RateLimiter(rate_limit)
        self.timeout = timeout

    async def generate_content(self, prompt: str) -> str:
        await self.limiter.wait()
        return await self._generate(prompt)

    @abstractmethod
    async def _generate(self, prompt: str) -> str: ...

    def generate_sync(self, prompt: str) -> str:
        """Blocking convenience wrapper for host pipelines."""
        return asyncio.run(self.generate_content(prompt))


async def _post_json(url: str, payload: dict, headers: dict, timeout: float = 60.0) -> dict:
    import httpx

    async with httpx.AsyncClient(timeout=timeout) as client:
        resp = await client.post(url, json=payload, headers=headers)
        if resp.status_code != 200:
            raise ProviderError(f"{url} -> {resp.status_code}: {resp.text[:500]}")
        return resp.json()


class GeminiProvider(LLMProvider):
    """Google Generative Language REST API (v1beta generateContent)."""

    BASE = "https://generativelanguage.googleapis.com/v1beta/models"

    def __init__(self, model_name: str = "gemini-2.0-flash", api_key: Optional[str] = None, rate_limit: float = 4.0):
        super().__init__(model_name, api_key, rate_limit)

    async def _generate(self, prompt: str) -> str:
        # Key goes in the header, NOT the URL: ProviderError embeds the URL
        # and the HTTP layer serves exception text to remote clients — a
        # query-param key would leak into 500 bodies and logs.
        url = f"{self.BASE}/{self.model_name}:generateContent"
        payload = {"contents": [{"parts": [{"text": prompt}]}]}
        headers = {"Content-Type": "application/json", "x-goog-api-key": self.api_key or ""}
        data = await _post_json(url, payload, headers, self.timeout)
        try:
            return data["candidates"][0]["content"]["parts"][0]["text"]
        except (KeyError, IndexError) as e:
            raise ProviderError(f"unexpected Gemini response shape: {data}") from e


class OpenAIChatProvider(LLMProvider):
    """OpenAI-compatible chat completions (OpenAI, Groq, vLLM endpoints)."""

    def __init__(
        self,
        model_name: str = "gpt-3.5-turbo",
        api_key: Optional[str] = None,
        base_url: str = "https://api.openai.com/v1",
        rate_limit: float = 1.0,
        temperature: float = 0.1,
        max_tokens: int = 8192,
    ):
        super().__init__(model_name, api_key, rate_limit)
        self.base_url = base_url.rstrip("/")
        self.temperature = temperature
        self.max_tokens = max_tokens

    async def _generate(self, prompt: str) -> str:
        payload = {
            "model": self.model_name,
            "messages": [{"role": "user", "content": prompt}],
            "temperature": self.temperature,
            "max_tokens": self.max_tokens,
        }
        headers = {"Authorization": f"Bearer {self.api_key}", "Content-Type": "application/json"}
        data = await _post_json(f"{self.base_url}/chat/completions", payload, headers, self.timeout)
        try:
            return data["choices"][0]["message"]["content"]
        except (KeyError, IndexError) as e:
            raise ProviderError(f"unexpected chat response shape: {data}") from e


class GPTProvider(OpenAIChatProvider):
    pass


class LlamaProvider(LLMProvider):
    """Groq-hosted Llama when an API key is set, local Ollama otherwise
    (dual-path behavior parity with the reference's LlamaProvider)."""

    def __init__(
        self,
        model_name: str = "llama3.1:8b",
        api_key: Optional[str] = None,
        base_url: str = "http://localhost:11434",
        rate_limit: float = 0.5,
    ):
        super().__init__(model_name, api_key, rate_limit)
        self.base_url = base_url
        self.use_groq = bool(api_key and api_key.strip())
        # Groq path honors the CALLER's model (Ollama-style names like
        # "llama3.1:8b" map to the reference's Groq default); hardcoding
        # would silently query a different — possibly decommissioned — model.
        groq_model = model_name if "versatile" in model_name or "-" in model_name else "llama-3.1-70b-versatile"
        self._groq = OpenAIChatProvider(
            groq_model, api_key, "https://api.groq.com/openai/v1", rate_limit=0.0
        )

    async def _generate(self, prompt: str) -> str:
        if self.use_groq:
            return await self._groq._generate(prompt)
        payload = {"model": self.model_name, "prompt": prompt, "stream": False}
        data = await _post_json(f"{self.base_url}/api/generate", payload, {}, self.timeout)
        return data.get("response", "")


class FakeProvider(LLMProvider):
    """Deterministic in-process provider for tests and offline runs.

    ``responder`` maps a prompt to a response (sync or async); default echoes
    an empty JSON object. ``canned`` replies are matched by regex in order.
    """

    def __init__(
        self,
        responder: Optional[Callable[[str], Union[str, Awaitable[str]]]] = None,
        canned: Optional[list[tuple[str, str]]] = None,
        rate_limit: float = 0.0,
    ):
        super().__init__("fake", None, rate_limit)
        self.responder = responder
        self.canned = canned or []
        self.calls: list[str] = []

    async def _generate(self, prompt: str) -> str:
        self.calls.append(prompt)
        if self.responder is not None:
            out = self.responder(prompt)
            if asyncio.iscoroutine(out):
                out = await out
            return out
        for pattern, response in self.canned:
            if re.search(pattern, prompt, re.IGNORECASE | re.DOTALL):
                return response
        return json.dumps({})


class ModelFactory:
    """Create a provider from a model-name string (reference :123-129)."""

    @staticmethod
    def create_provider(model_name: str, api_key: Optional[str] = None, **kwargs) -> LLMProvider:
        rate = float(SUPPORTED_MODELS.get(model_name, {}).get("rate_limit", 1.0))
        if model_name == "fake":
            return FakeProvider(**kwargs)
        if "gemini" in model_name:
            return GeminiProvider(model_name, api_key, rate_limit=rate)
        if "llama" in model_name or "groq" in model_name:
            return LlamaProvider(model_name, api_key, rate_limit=rate, **kwargs)
        if "gpt" in model_name:
            return GPTProvider(model_name, api_key, rate_limit=rate, **kwargs)
        raise ValueError(f"unknown model: {model_name}")
