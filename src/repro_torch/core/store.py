"""Content-address validation, the part of ``repro.core.store`` that the
evaluation path needs (the tiered artifact store itself is not ported yet).

Content addresses are sha256 hex digests — anything else is rejected before
it can reach a filesystem path or a resolver."""
from __future__ import annotations

import re

KEY_RE = re.compile(r"[0-9a-f]{64}")


def valid_key(key: str) -> bool:
    """True iff ``key`` is a well-formed content address."""
    return isinstance(key, str) and KEY_RE.fullmatch(key) is not None
