"""Session checkpoint/resume (``session.py``), video sources and the device
feed (``video.py``), the MJPEG helpers and the test-stream JPEG encoder."""
