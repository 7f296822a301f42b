"""The command line of the port (``main.py``)."""
