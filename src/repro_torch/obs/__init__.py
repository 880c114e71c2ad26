"""Observability for the simulation grid: copies of the stdlib-only
``repro/obs`` modules (schema, export, metrics, trace)."""
