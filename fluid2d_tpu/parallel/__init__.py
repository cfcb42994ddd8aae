"""Grid sharding over device meshes (GSPMD and explicit halo paths)."""
