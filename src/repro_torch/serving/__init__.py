"""Serving stack: backends, scheduler, admission, event loop, engine."""
