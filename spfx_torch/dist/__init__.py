"""Device meshes for the port (a one-process mesh; the multi-device engines
are not ported yet)."""
