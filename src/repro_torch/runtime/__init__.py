"""Serving steps of the port (``steps.py``); the train step, optimizer and
multi-device runtime wait for later slices (ROADMAP A7, A9)."""
