"""Remote-viewer protocol server (SIBR-compatible) and a local viewer."""
