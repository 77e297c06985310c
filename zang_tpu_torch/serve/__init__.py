"""The serving tiers on torch: the batch fleet (serve/batch.py), the HTTP
render tier (serve/http.py), LiveFleet (serve/live.py), the TCP server
and client (serve/server.py, serve/client.py).

Lazy re-exports: `python -m zang_tpu_torch.serve.server` (or `.http`,
`.batch`) must not re-execute a module this package already imported
(runpy warns), and the thin TCP client should not pay for torch's import.
"""

_LAZY = {
    "BatchRenderer": ("zang_tpu_torch.serve.batch", "BatchRenderer"),
    "RenderHTTPServer": ("zang_tpu_torch.serve.http", "RenderHTTPServer"),
    "RenderJob": ("zang_tpu_torch.serve.batch", "RenderJob"),
    "render_song_shared": ("zang_tpu_torch.serve.batch", "render_song_shared"),
    "SharedGraphCache": ("zang_tpu_torch.serve.batch", "SharedGraphCache"),
    "TerminalPlayer": ("zang_tpu_torch.serve.client", "TerminalPlayer"),
    "LiveFleet": ("zang_tpu_torch.serve.live", "LiveFleet"),
    "LiveClient": ("zang_tpu_torch.serve.server", "LiveClient"),
    "LiveServer": ("zang_tpu_torch.serve.server", "LiveServer"),
    "MultiInstrumentServer": ("zang_tpu_torch.serve.server", "MultiInstrumentServer"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'zang_tpu_torch.serve' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
