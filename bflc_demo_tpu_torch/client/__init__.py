"""Client runtimes: the in-process host runtime (`simulation`) and the
mesh runtime (`mesh_runtime`)."""
