"""Serving substrate of the port: prefill / decode step factories.
Training (optimizer, train step, data, gradient compression) is not
ported yet (ROADMAP.md section 1)."""
from . import serve_step
