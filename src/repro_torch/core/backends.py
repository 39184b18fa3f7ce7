"""Phase 2 — Symbolic Inference backends.

`LLMBackend` is the pluggable protocol; `MockLLMBackend` deterministically
replays the behaviour the paper measured per (model, domain, stage) cell so
the whole pipeline — prompt building, code extraction, synthesis, validation,
energy accounting, deployment — runs end-to-end offline.  `OllamaBackend`
shows the production wiring for real local models (paper Sec. V ran GGUF
models under default parameters).  ``EngineBackend`` drives the in-repo
serving engine (a smoke-config transformer on the card) as a real backend.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
from typing import Protocol

import numpy as np

from repro_torch.core import paper_tables as pt
from repro_torch.core.domains import Domain

# ---------------------------------------------------------------------------
# Appendix A prompt
# ---------------------------------------------------------------------------

PROMPT_TEMPLATE = """<ROLE>
Act as an expert in mathematics and cryptography, specializing in the reverse
engineering of algorithms and the identification of complex patterns in
multidimensional spaces. Your goal is SOLELY to generate the Python code
requested.
</ROLE>

<TASK>
Analyze the mapping data in the <CONTEXT> to find the underlying mathematical
algorithm.

Then, generate the complete source code for a single Python function that
implements this general algorithm.
</TASK>

<CONTEXT>
# Mapping Data
{mapping_data}
</CONTEXT>

<RULES>
- Function name must be exactly `map_to_coordinates(n)`.
- Input: 'n' (non-negative integer).
- Output: tuple of integers representing coordinates.
- Each integer within the returned coordinate tuple must be greater than or
  equal to 0.
- Validate input 'n' (non-negative integer), raise 'ValueError' if invalid.
- **CRITICAL ALGORITHM CONSTRAINT:** The function MUST implement a general
  mathematical algorithm that works for ANY non-negative integer 'n', not just
  the examples provided.
- **DO NOT use hardcoded values, lookup tables, or long 'if/elif' chains based
  on ranges of 'n'.**
- **CRITICAL OUTPUT CONSTRAINT:** Your response MUST contain ONLY the Python
  code block for the function.
- **DO NOT include ANY introductory text, explanations, reasoning, thought
  processes, or comments.**
- Do NOT include an 'if __name__ == "__main__":' block.
</RULES>

<RESPONSE>
"""


def sample_context(domain: Domain, stage: int) -> np.ndarray:
    """Phase 1 — Context Sampling: first `stage` points (sequential CPU)."""
    return domain.enumerate_points(stage)


def build_prompt(domain: Domain, stage: int) -> str:
    pts = sample_context(domain, stage)
    lines = [f"{i} -> {tuple(int(v) for v in p)}" for i, p in enumerate(pts)]
    return PROMPT_TEMPLATE.format(mapping_data="\n".join(lines))


# ---------------------------------------------------------------------------
# Backend protocol + typed errors
# ---------------------------------------------------------------------------


class LLMError(RuntimeError):
    """Base class for backend failures the serving tier maps onto wire
    codes — anything else escaping a backend is a plain 500."""


class LLMBusyError(LLMError):
    """Generation admission is saturated: shed now, retry later (HTTP 503).

    The batching layer's ``AdmissionError`` subclasses this, so every
    admission-control path in the stack speaks one retryable error type."""


class LLMTimeoutError(LLMError):
    """Generation exceeded its configured deadline (HTTP 504).  Retryable:
    the work was cancelled, not answered — a repeat is safe (derivations
    are idempotent by content address)."""


class LLMUnavailableError(LLMError):
    """The configured backend cannot be reached at all (HTTP 503)."""


@dataclasses.dataclass
class LLMResponse:
    text: str
    model: str
    tokens_in: int
    tokens_out: int
    seconds: float
    joules: float


class LLMBackend(Protocol):
    name: str

    def generate(self, prompt: str, *, meta: dict) -> LLMResponse: ...


class AsyncLLMBackend(Protocol):
    """Async backend protocol for event-loop serving (``serving/aio.py``).

    Lifecycle mirrors the sync protocol's implicit one, made explicit so a
    server can manage it: ``start`` loads weights / spawns workers,
    ``warm`` primes compilation with a throwaway generate, ``health_check``
    answers liveness probes without generating, ``close`` releases
    everything.  ``generate`` raises the typed errors above
    (:class:`LLMBusyError` when admission is saturated,
    :class:`LLMTimeoutError` past the deadline) so the HTTP layer can map
    them to 503/504 without string matching."""

    name: str

    async def start(self) -> None: ...

    async def close(self) -> None: ...

    async def health_check(self) -> bool: ...

    async def warm(self, timeout_s: float = 120.0) -> None: ...

    async def generate(self, prompt: str, *, meta: dict) -> LLMResponse: ...


class AsyncBackendAdapter:
    """Wrap any sync :class:`LLMBackend` into the async protocol by
    offloading ``generate`` to the running loop's default executor — the
    bridge that lets the mock/ollama backends serve behind the asyncio
    frontend without their own async implementations."""

    def __init__(self, inner: LLMBackend):
        self.inner = inner
        self.name = inner.name

    @property
    def cache_fingerprint(self):
        return getattr(self.inner, "cache_fingerprint", None)

    async def start(self) -> None:
        start = getattr(self.inner, "start", None)
        if callable(start):
            start()

    async def close(self) -> None:
        close = getattr(self.inner, "close", None)
        if callable(close):
            close()

    async def health_check(self) -> bool:
        return True

    async def warm(self, timeout_s: float = 120.0) -> None:
        return None

    async def generate(self, prompt: str, *, meta: dict) -> LLMResponse:
        import asyncio
        import functools

        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, functools.partial(self.inner.generate, prompt, meta=meta))


# ---------------------------------------------------------------------------
# Code templates the mock backend emits, per (domain, logic-class)
# ---------------------------------------------------------------------------

_HDR = (
    "def map_to_coordinates(n):\n"
    "    if not isinstance(n, int) or isinstance(n, bool) or n < 0:\n"
    "        raise ValueError('n must be a non-negative integer')\n"
)

CODE_TEMPLATES: dict[tuple[str, str], str] = {
    ("tri2d", "analytical"): (
        "import math\n" + _HDR +
        "    x = (math.isqrt(8 * n + 1) - 1) // 2\n"
        "    y = n - x * (x + 1) // 2\n"
        "    return (x, y)\n"
    ),
    ("tri2d", "sqrt_loop"): (
        _HDR +
        "    x = int((2.0 * n) ** 0.5)\n"
        "    while (x + 1) * (x + 2) // 2 <= n:\n"
        "        x += 1\n"
        "    while x * (x + 1) // 2 > n:\n"
        "        x -= 1\n"
        "    return (x, n - x * (x + 1) // 2)\n"
    ),
    ("tri2d", "binsearch"): (
        _HDR +
        "    lo, hi = 0, 1\n"
        "    while hi * (hi + 1) // 2 <= n:\n"
        "        hi *= 2\n"
        "    while lo < hi:\n"
        "        mid = (lo + hi + 1) // 2\n"
        "        if mid * (mid + 1) // 2 <= n:\n"
        "            lo = mid\n"
        "        else:\n"
        "            hi = mid - 1\n"
        "    return (lo, n - lo * (lo + 1) // 2)\n"
    ),
    ("tri2d", "approx_if"): (
        _HDR +
        "    x = int(((8.0 * n + 1.0) ** 0.5 - 1.0) / 2.0)\n"
        "    if (x + 1) * (x + 2) // 2 <= n:\n"
        "        x += 1\n"
        "    if x * (x + 1) // 2 > n:\n"
        "        x -= 1\n"
        "    return (x, n - x * (x + 1) // 2)\n"
    ),
    ("pyramid3d", "analytical"): (
        "import math\n" + _HDR +
        "    z = int((6.0 * n) ** (1.0 / 3.0))\n"
        "    if (z + 1) * (z + 2) * (z + 3) // 6 <= n:\n"
        "        z += 1\n"
        "    if z > 0 and z * (z + 1) * (z + 2) // 6 > n:\n"
        "        z -= 1\n"
        "    if z > 0 and z * (z + 1) * (z + 2) // 6 > n:\n"
        "        z -= 1\n"
        "    r = n - z * (z + 1) * (z + 2) // 6\n"
        "    x = (math.isqrt(8 * r + 1) - 1) // 2\n"
        "    y = r - x * (x + 1) // 2\n"
        "    return (x, y, z)\n"
    ),
    ("pyramid3d", "cbrt_loop"): (
        "import math\n" + _HDR +
        "    z = int(round((6.0 * n) ** (1.0 / 3.0)))\n"
        "    while (z + 1) * (z + 2) * (z + 3) // 6 <= n:\n"
        "        z += 1\n"
        "    while z > 0 and z * (z + 1) * (z + 2) // 6 > n:\n"
        "        z -= 1\n"
        "    r = n - z * (z + 1) * (z + 2) // 6\n"
        "    x = (math.isqrt(8 * r + 1) - 1) // 2\n"
        "    return (x, r - x * (x + 1) // 2, z)\n"
    ),
    ("pyramid3d", "binsearch"): (
        "import math\n" + _HDR +
        "    lo, hi = 0, 1\n"
        "    while hi * (hi + 1) * (hi + 2) // 6 <= n:\n"
        "        hi *= 2\n"
        "    while lo < hi:\n"
        "        mid = (lo + hi + 1) // 2\n"
        "        if mid * (mid + 1) * (mid + 2) // 6 <= n:\n"
        "            lo = mid\n"
        "        else:\n"
        "            hi = mid - 1\n"
        "    r = n - lo * (lo + 1) * (lo + 2) // 6\n"
        "    x = (math.isqrt(8 * r + 1) - 1) // 2\n"
        "    return (x, r - x * (x + 1) // 2, lo)\n"
    ),
    ("pyramid3d", "binsearch_linear"): (
        "import math\n" + _HDR +
        "    hi = 1\n"
        "    while hi * (hi + 1) * (hi + 2) // 6 <= n:\n"
        "        hi *= 2\n"
        "    z = 0\n"
        "    while (z + 1) * (z + 2) * (z + 3) // 6 <= n:\n"
        "        z += 1\n"
        "    r = n - z * (z + 1) * (z + 2) // 6\n"
        "    y = 0\n"
        "    while (y + 1) * (y + 2) // 2 <= r:\n"
        "        y += 1\n"
        "    return (y, r - y * (y + 1) // 2, z)\n"
    ),
    ("pyramid3d", "linear"): (
        _HDR +
        "    z = 0\n"
        "    while (z + 1) * (z + 2) * (z + 3) // 6 <= n:\n"
        "        z += 1\n"
        "    r = n - z * (z + 1) * (z + 2) // 6\n"
        "    x = 0\n"
        "    while (x + 1) * (x + 2) // 2 <= r:\n"
        "        x += 1\n"
        "    return (x, r - x * (x + 1) // 2, z)\n"
    ),
    ("gasket2d", "bitwise"): (
        _HDR +
        "    x = 0\n    y = 0\n    s = 1\n    m = n\n"
        "    while m > 0:\n"
        "        d = m % 3\n"
        "        if d == 1:\n            x += s\n"
        "        elif d == 2:\n            y += s\n"
        "        m //= 3\n        s *= 2\n"
        "    return (x, y)\n"
    ),
    ("carpet2d", "bitwise"): (
        _HDR +
        "    cells = ((0, 0), (0, 1), (0, 2), (1, 0), (1, 2), (2, 0), (2, 1), (2, 2))\n"
        "    x = 0\n    y = 0\n    s = 1\n    m = n\n"
        "    while m > 0:\n"
        "        vx, vy = cells[m % 8]\n"
        "        x += vx * s\n        y += vy * s\n"
        "        m //= 8\n        s *= 3\n"
        "    return (x, y)\n"
    ),
    ("sierpinski3d", "bitwise"): (
        _HDR +
        "    x = 0\n    y = 0\n    z = 0\n    s = 1\n    m = n\n"
        "    while m > 0:\n"
        "        d = m % 4\n"
        "        if d == 1:\n            x += s\n"
        "        elif d == 2:\n            y += s\n"
        "        elif d == 3:\n            z += s\n"
        "        m //= 4\n        s *= 2\n"
        "    return (x, y, z)\n"
    ),
    ("menger3d", "bitwise"): (
        _HDR +
        "    cells = ((0, 0, 0), (0, 0, 1), (0, 0, 2), (0, 1, 0), (0, 1, 2),\n"
        "             (0, 2, 0), (0, 2, 1), (0, 2, 2), (1, 0, 0), (1, 0, 2),\n"
        "             (1, 2, 0), (1, 2, 2), (2, 0, 0), (2, 0, 1), (2, 0, 2),\n"
        "             (2, 1, 0), (2, 1, 2), (2, 2, 0), (2, 2, 1), (2, 2, 2))\n"
        "    x = 0\n    y = 0\n    z = 0\n    s = 1\n    m = n\n"
        "    while m > 0:\n"
        "        vx, vy, vz = cells[m % 20]\n"
        "        x += vx * s\n        y += vy * s\n        z += vz * s\n"
        "        m //= 20\n        s *= 3\n"
        "    return (x, y, z)\n"
    ),
}

# canonical *failure* modes for non-perfect cells ---------------------------

_FAIL_2D_ROWMAJOR = (
    _HDR +
    "    width = 1000\n"
    "    return (n // width, n % width)\n"
)
_FAIL_3D_ROWMAJOR = (
    _HDR +
    "    side = 100\n"
    "    return (n // (side * side), (n // side) % side, n % side)\n"
)
_FAIL_WRONG_BASE_2D = (
    _HDR +
    "    x = 0\n    y = 0\n    s = 1\n    m = n\n"
    "    while m > 0:\n"
    "        d = m % 4\n"
    "        if d == 1:\n            x += s\n"
    "        elif d == 2:\n            y += s\n"
    "        elif d == 3:\n            x += s\n            y += s\n"
    "        m //= 4\n        s *= 2\n"
    "    return (x, y)\n"
)
_FAIL_WRONG_BASE_3D = (
    _HDR +
    "    x = 0\n    y = 0\n    z = 0\n    s = 1\n    m = n\n"
    "    while m > 0:\n"
    "        d = m % 8\n"
    "        x += (d & 1) * s\n"
    "        y += ((d >> 1) & 1) * s\n"
    "        z += ((d >> 2) & 1) * s\n"
    "        m //= 8\n        s *= 2\n"
    "    return (x, y, z)\n"
)
# correct geometry, permuted traversal order ("silver standard")
_PERMUTED = {
    "tri2d": (
        "import math\n" + _HDR +
        "    x = (math.isqrt(8 * n + 1) - 1) // 2\n"
        "    y = n - x * (x + 1) // 2\n"
        "    return (x, x - y)\n"  # column order reversed within each row
    ),
    "pyramid3d": (
        "import math\n" + _HDR +
        "    z = int(round((6.0 * n) ** (1.0 / 3.0)))\n"
        "    while (z + 1) * (z + 2) * (z + 3) // 6 <= n:\n"
        "        z += 1\n"
        "    while z > 0 and z * (z + 1) * (z + 2) // 6 > n:\n"
        "        z -= 1\n"
        "    r = n - z * (z + 1) * (z + 2) // 6\n"
        "    x = (math.isqrt(8 * r + 1) - 1) // 2\n"
        "    y = r - x * (x + 1) // 2\n"
        "    return (x, x - y, z)\n"
    ),
    "gasket2d": (
        _HDR +
        "    x = 0\n    y = 0\n    s = 1\n    m = n\n"
        "    while m > 0:\n"
        "        d = m % 3\n"
        "        if d == 1:\n            y += s\n"  # axes swapped
        "        elif d == 2:\n            x += s\n"
        "        m //= 3\n        s *= 2\n"
        "    return (x, y)\n"
    ),
    "carpet2d": (
        _HDR +
        "    cells = ((0, 0), (1, 0), (2, 0), (0, 1), (2, 1), (0, 2), (1, 2), (2, 2))\n"
        "    x = 0\n    y = 0\n    s = 1\n    m = n\n"
        "    while m > 0:\n"
        "        vx, vy = cells[m % 8]\n"
        "        x += vx * s\n        y += vy * s\n"
        "        m //= 8\n        s *= 3\n"
        "    return (x, y)\n"
    ),
    "sierpinski3d": (
        _HDR +
        "    x = 0\n    y = 0\n    z = 0\n    s = 1\n    m = n\n"
        "    while m > 0:\n"
        "        d = m % 4\n"
        "        if d == 1:\n            z += s\n"
        "        elif d == 2:\n            y += s\n"
        "        elif d == 3:\n            x += s\n"
        "        m //= 4\n        s *= 2\n"
        "    return (x, y, z)\n"
    ),
    "menger3d": (
        _HDR +
        "    cells = ((0, 0, 0), (1, 0, 0), (2, 0, 0), (0, 1, 0), (2, 1, 0),\n"
        "             (0, 2, 0), (1, 2, 0), (2, 2, 0), (0, 0, 1), (2, 0, 1),\n"
        "             (0, 2, 1), (2, 2, 1), (0, 0, 2), (1, 0, 2), (2, 0, 2),\n"
        "             (0, 1, 2), (2, 1, 2), (0, 2, 2), (1, 2, 2), (2, 2, 2))\n"
        "    x = 0\n    y = 0\n    z = 0\n    s = 1\n    m = n\n"
        "    while m > 0:\n"
        "        vx, vy, vz = cells[m % 20]\n"
        "        x += vx * s\n        y += vy * s\n        z += vz * s\n"
        "        m //= 20\n        s *= 3\n"
        "    return (x, y, z)\n"
    ),
}
_NONCOMPILING = "def map_to_coordinates(n:\n    return (n,\n"

# --- extension domains (not in the paper's tables) -------------------------
# The m-simplex and embedded-fractal families are beyond-paper scenarios; the
# replay bank emits the canonical derivation for them (every model "solves"
# them), so extension cells exercise the full synthesize/validate/deploy path
# without inventing unmeasured failure tables.


def _simplex_template(m: int) -> str:
    """Canonical m-level peel: float m-th-root seed + exact ladder."""
    return (
        "import math\n" + _HDR +
        "    lam = n\n"
        "    coords = []\n"
        f"    for level in range({m}, 0, -1):\n"
        "        x = int(round((math.factorial(level) * lam) "
        "** (1.0 / level)))\n"
        "        while math.comb(x + level, level) <= lam:\n"
        "            x += 1\n"
        "        while x > 0 and math.comb(x + level - 1, level) > lam:\n"
        "            x -= 1\n"
        "        coords.append(x)\n"
        "        lam -= math.comb(x + level - 1, level)\n"
        "    return tuple(reversed(coords))\n"
    )


def _digit_fractal_template(base: int, scale: int, vecs) -> str:
    """Canonical digit decomposition over the generator cell table."""
    cells = ", ".join(repr(tuple(int(x) for x in v)) for v in vecs)
    dim = len(vecs[0])
    names = ["x", "y", "z"][:dim]
    unpack = ", ".join(f"v{k}" for k in range(dim))
    return (
        _HDR +
        f"    cells = ({cells})\n"
        + "".join(f"    {nm} = 0\n" for nm in names)
        + "    s = 1\n    m = n\n"
        "    while m > 0:\n"
        f"        {unpack}{',' if dim == 1 else ''} = cells[m % {base}]\n"
        + "".join(f"        {nm} += v{k} * s\n"
                  for k, nm in enumerate(names))
        + f"        m //= {base}\n        s *= {scale}\n"
        f"    return ({', '.join(names)})\n"
    )


def extension_behavior(domain: str) -> tuple[str, str]:
    """(logic-class, code) for a beyond-paper domain, generated from the
    Domain's own geometry metadata — no per-domain table entries needed."""
    from repro_torch.core.domains import SimplexDomain, get_domain

    d = get_domain(domain)
    if isinstance(d, SimplexDomain):
        return "analytical", _simplex_template(d.m)
    if d.kind == "fractal":
        return "bitwise", _digit_fractal_template(d.base, d.scale, d.vecs)
    raise KeyError(f"no replay behavior for extension domain {domain!r}")


def mock_behavior(domain: str, model: str, stage: int) -> tuple[str, str]:
    """(behavior-class, code) the replay bank emits for one table cell."""
    if domain not in pt.ACCURACY:
        return extension_behavior(domain)
    stage_idx = pt.STAGES.index(stage)
    ordered, any_order, compiled = pt.ACCURACY[domain][model][stage_idx]
    if not compiled:
        return "noncompiling", _NONCOMPILING
    if ordered >= 100.0:
        logic = pt.LOGIC_CLASS_OVERRIDES.get(
            (domain, model, stage),
            "analytical" if domain in ("tri2d", "pyramid3d") else "bitwise",
        )
        return logic, CODE_TEMPLATES[(domain, logic)]
    if any_order >= 5.0:  # geometry mostly right, order wrong
        return "permuted", _PERMUTED[domain]
    if domain in ("tri2d", "pyramid3d"):
        return "rowmajor_fit", (_FAIL_2D_ROWMAJOR if domain == "tri2d"
                                else _FAIL_3D_ROWMAJOR)
    return "wrong_base", (_FAIL_WRONG_BASE_2D if domain in ("gasket2d", "carpet2d")
                          else _FAIL_WRONG_BASE_3D)


# ---------------------------------------------------------------------------
# Model priors for the energy/time model of the inference phase (Sec. V.B).
# params in billions; tps = generation tok/s on 4xA100 (modeled priors);
# reasoning models multiply emitted tokens by the CoT factor.
# ---------------------------------------------------------------------------

MODEL_SPECS = {
    "R1:70b":      dict(params_b=70.6, tps=28.0, cot_factor=12.0, power_w=1100.0),
    "Gem3:12b":    dict(params_b=12.2, tps=95.0, cot_factor=1.0, power_w=700.0),
    "Gem3:27b":    dict(params_b=27.4, tps=55.0, cot_factor=1.0, power_w=850.0),
    "OSS:120b":    dict(params_b=116.8, tps=45.0, cot_factor=3.0, power_w=1250.0),
    "OSS:20b":     dict(params_b=20.9, tps=120.0, cot_factor=3.0, power_w=750.0),
    "Lla3.3:70b":  dict(params_b=70.6, tps=30.0, cot_factor=1.0, power_w=1100.0),
    "Lla4:16x17b": dict(params_b=108.6, tps=60.0, cot_factor=1.0, power_w=1200.0),
    "Mist-N:12b":  dict(params_b=12.2, tps=100.0, cot_factor=1.0, power_w=700.0),
    "Nemo:70b":    dict(params_b=70.6, tps=30.0, cot_factor=1.0, power_w=1100.0),
    "Qw3:235b":    dict(params_b=235.1, tps=18.0, cot_factor=4.0, power_w=1400.0),
    "Qw3:32b":     dict(params_b=32.8, tps=50.0, cot_factor=4.0, power_w=900.0),
}


_REPLAY_BANK_FINGERPRINTS: dict[tuple, str] = {}


def replay_bank_fingerprint() -> str:
    """Content hash of the mock replay bank; folded into artifact-cache keys
    so edits to the measured tables / code templates invalidate cached
    derivations instead of silently replaying stale results.

    The generated extension templates are bank content too — the emitted
    code itself is hashed, so a generator edit invalidates those cells, and
    the memo is keyed by the registered extension-domain set so late plugin
    registrations are picked up rather than frozen out."""
    from repro_torch.core.domains import DOMAINS

    ext_names = tuple(sorted(set(DOMAINS) - set(pt.ACCURACY)))
    if ext_names not in _REPLAY_BANK_FINGERPRINTS:
        ext = []
        for name in ext_names:
            try:
                ext.append((name, *extension_behavior(name)))
            except KeyError:
                pass  # a domain the replay bank cannot serve — see mock_behavior
        payload = repr((pt.ACCURACY, pt.LOGIC_CLASS_OVERRIDES, CODE_TEMPLATES,
                        _PERMUTED, _FAIL_2D_ROWMAJOR, _FAIL_3D_ROWMAJOR,
                        _FAIL_WRONG_BASE_2D, _FAIL_WRONG_BASE_3D,
                        _NONCOMPILING, MODEL_SPECS, tuple(ext)))
        _REPLAY_BANK_FINGERPRINTS[ext_names] = hashlib.sha256(
            payload.encode()).hexdigest()[:16]
    return _REPLAY_BANK_FINGERPRINTS[ext_names]


class MockLLMBackend:
    """Deterministic replay of the paper's measured per-cell behaviour."""

    def __init__(self, model: str):
        if model not in pt.MODELS:
            raise ValueError(f"unknown model {model!r}; have {pt.MODELS}")
        self.name = model
        self.spec = MODEL_SPECS[model]

    @property
    def cache_fingerprint(self) -> str:
        return replay_bank_fingerprint()

    def generate(self, prompt: str, *, meta: dict) -> LLMResponse:
        domain, stage = meta["domain"], meta["stage"]
        _, code = mock_behavior(domain, self.name, stage)
        tokens_in = max(len(prompt) // 4, 1)
        code_tokens = max(len(code) // 4, 1)
        tokens_out = int(code_tokens * self.spec["cot_factor"])
        seconds = tokens_out / self.spec["tps"] + tokens_in / (self.spec["tps"] * 8)
        joules = seconds * self.spec["power_w"]
        return LLMResponse(
            text=f"```python\n{code}```", model=self.name,
            tokens_in=tokens_in, tokens_out=tokens_out,
            seconds=seconds, joules=joules,
        )


def canonical_code(domain: str) -> str:
    """The canonical perfect derivation for any registered domain — the
    paper domains' analytical/bitwise templates, or the geometry-generated
    template for extension families."""
    if domain in pt.ACCURACY:
        logic = "analytical" if domain in ("tri2d", "pyramid3d") else "bitwise"
        return CODE_TEMPLATES[(domain, logic)]
    return extension_behavior(domain)[1]


NO_CARD_ENGINE = ("EngineBackend runs its model on the card and this "
                  "machine has no CUDA device: pass device=\"cpu\" "
                  "(--device cpu) to run it on the CPU")


class EngineBackend:
    """LLMBackend over the in-repo batched serving engine (`serving/engine`).

    This is the 'real backend' wiring: a smoke-config transformer runs true
    prefill + step-wise decode over the (byte-tokenized) Appendix-A prompt —
    deterministic because params come from a fixed seed and decoding is
    greedy by default.  The smoke model is untrained, so its sampled text
    essentially never synthesizes into a valid ``map_to_coordinates``; when
    synthesis of the sampled text fails, the backend falls back to the
    canonical derivation for the requested domain, exactly as the mock's
    extension path does — so the pipeline downstream (synthesis, validation,
    artifact publish) always exercises its real code path, while the
    inference cost (wall seconds, modeled joules) is *measured* from the
    actual prefill/decode run rather than replayed from priors.

    ``generate_batch`` pads a group of prompts to one (B, S) call — one
    prefill for the whole batch — which is what the serving layer's
    ``BatchingBackend`` drives when concurrent derive requests for the same
    model are admitted together.

    The model runs on ``device`` (None: the card; without one the first
    generate raises, naming ``device="cpu"``).  Its weights come from a
    ``torch.Generator`` seeded 0: the reference's distributions, not its
    numbers (``jax.random``'s draws are not reproduced), so its sampled
    tokens equal the reference's only with the reference's weights loaded.
    ``seconds`` runs until the sampled tokens are back on the host, so it
    holds the device's work.
    """

    def __init__(self, model: str, arch: str = "yi-6b",
                 prompt_tokens: int = 48, max_new_tokens: int = 16,
                 temperature: float = 0.0, seed: int = 0,
                 power_w: float | None = None, device=None):
        self.name = model
        self.arch = arch
        self.prompt_tokens = prompt_tokens
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.seed = seed
        spec = MODEL_SPECS.get(model)
        self.power_w = power_w if power_w is not None else (
            spec["power_w"] if spec else 1000.0)
        self.device = device
        self._engine = None  # (params, cfg) built lazily: torch + init
        self._mu = threading.Lock()

    @property
    def cache_fingerprint(self) -> str:
        """Engine cells must never collide with mock cells for the same
        (domain, model, stage): the fingerprint carries the backend kind,
        the arch + decode knobs, and the canonical-fallback bank hash.  The
        device is not a knob: the reference's engine cells keep their
        content addresses."""
        knobs = (self.arch, self.prompt_tokens, self.max_new_tokens,
                 self.temperature, self.seed)
        return f"engine:{knobs!r}:{replay_bank_fingerprint()}"

    def _ensure_engine(self):
        with self._mu:
            if self._engine is None:
                import torch

                from repro_torch.configs import get_smoke_config
                from repro_torch.models import transformer as T

                device = torch.device(self.device or "cuda")
                if device.type == "cuda" and not torch.cuda.is_available():
                    raise RuntimeError(NO_CARD_ENGINE)
                cfg = get_smoke_config(self.arch).replace(
                    max_seq=self.prompt_tokens + self.max_new_tokens,
                    pallas_interpret=device.type == "cpu")
                gen = torch.Generator(device=device).manual_seed(0)
                self._engine = (T.init_params(cfg, gen, device), cfg)
        return self._engine

    def _tokenize(self, prompt: str, vocab: int) -> np.ndarray:
        """Byte-level tokens from the prompt *tail* (the mapping-data lines —
        the part that varies per (domain, stage)), fixed length so a batch
        needs no ragged padding."""
        raw = prompt.encode()[-self.prompt_tokens:]
        ids = np.frombuffer(raw, dtype=np.uint8).astype(np.int32) % vocab
        if len(ids) < self.prompt_tokens:
            ids = np.pad(ids, (self.prompt_tokens - len(ids), 0))
        return ids

    @staticmethod
    def _detokenize(ids) -> str:
        return "".join(chr(i) if 32 <= i < 127 else " "
                       for i in np.asarray(ids).tolist())

    def generate(self, prompt: str, *, meta: dict) -> LLMResponse:
        return self.generate_batch([prompt], [meta])[0]

    def sample(self, prompts: list[str]):
        """One padded prefill + shared decode loop for the whole group:
        (prompt tokens (B, S), sampled tokens (B, steps), steps, wall
        seconds with the tokens read back)."""
        import time

        import torch

        from repro_torch.serving import engine

        params, cfg = self._ensure_engine()
        toks = np.stack([self._tokenize(p, cfg.vocab_size) for p in prompts])
        t0 = time.monotonic()
        res = engine.generate(params, cfg, torch.from_numpy(toks),
                              self.max_new_tokens,
                              temperature=self.temperature, seed=self.seed)
        sampled = res.tokens[:, self.prompt_tokens:].cpu().numpy()
        return toks, sampled, int(res.steps), time.monotonic() - t0

    def respond(self, row, meta: dict, tokens_in: int, tokens_out: int,
                seconds: float) -> LLMResponse:
        """The response for one request's sampled tokens ``row``."""
        from repro_torch.core import synthesis

        text = self._detokenize(row)
        try:
            synthesis.synthesize(text)
        except synthesis.SynthesisError:
            # the smoke model can't derive maps — fall back to the
            # canonical derivation so downstream stages stay live
            text = f"```python\n{canonical_code(meta['domain'])}```"
        return LLMResponse(
            text=text, model=self.name, tokens_in=tokens_in,
            tokens_out=tokens_out, seconds=seconds,
            joules=seconds * self.power_w)

    def generate_batch(self, prompts: list[str],
                       metas: list[dict]) -> list[LLMResponse]:
        """One padded prefill + shared decode loop for the whole group."""
        toks, sampled, steps, seconds = self.sample(prompts)
        per_seconds = seconds / len(prompts)
        return [self.respond(row, meta, toks.shape[1], steps, per_seconds)
                for meta, row in zip(metas, sampled)]


class OllamaBackend:
    """Production wiring for real local GGUF models (offline-unavailable)."""

    def __init__(self, model: str, host: str = "http://localhost:11434",
                 power_w: float = 1000.0):
        self.name = model
        self.host = host
        self.power_w = power_w

    def generate(self, prompt: str, *, meta: dict) -> LLMResponse:
        import socket
        import time
        import urllib.error
        import urllib.request

        body = json.dumps(
            {"model": self.name, "prompt": prompt, "stream": False}
        ).encode()
        req = urllib.request.Request(
            f"{self.host}/api/generate", data=body,
            headers={"Content-Type": "application/json"},
        )
        t0 = time.monotonic()
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:  # noqa: S310
                payload = json.loads(resp.read())
        except (TimeoutError, socket.timeout) as e:
            raise LLMTimeoutError(
                f"ollama generate on {self.name!r} timed out") from e
        except urllib.error.URLError as e:
            if isinstance(e.reason, (TimeoutError, socket.timeout)):
                raise LLMTimeoutError(
                    f"ollama generate on {self.name!r} timed out") from e
            raise LLMUnavailableError(
                f"ollama at {self.host} unreachable: {e.reason}") from e
        dt = time.monotonic() - t0
        return LLMResponse(
            text=payload.get("response", ""), model=self.name,
            tokens_in=payload.get("prompt_eval_count", 0),
            tokens_out=payload.get("eval_count", 0),
            seconds=dt, joules=dt * self.power_w,
        )


def response_fingerprint(resp: LLMResponse) -> str:
    return hashlib.sha256(resp.text.encode()).hexdigest()[:16]
