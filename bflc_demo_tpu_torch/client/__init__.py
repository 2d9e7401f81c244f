"""Client runtimes (the in-process host runtime so far)."""
