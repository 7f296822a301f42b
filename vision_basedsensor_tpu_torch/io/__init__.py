"""Session checkpoint/resume (``session.py``); the ingest comes later."""
