"""Capture-and-replay compilation and the persistent artifact cache (port
of ``compile/``).

``engine_jit`` is the chokepoint every compiled program of the port is
built through: per signature it captures one call into a CUDA graph and
replays it (``engine.py``); ``cache.py`` keeps the port's cold-start
compile, the kernel libraries ``nvcc`` builds, as content-addressed
files, so a warm process copies them instead of building.
"""

from analytics_zoo_torch.compile.cache import (  # noqa: F401
    ENV_CACHE_DIR, ExecutableCache, backend_signature, cache_key,
    get_cache, reset_cache_state, resolve_cache_dir, runtime_versions)
from analytics_zoo_torch.compile.engine import (  # noqa: F401
    EngineJit, call_signature, engine_jit)
