"""Host-side data: synthetic scenes, MOT15 sizes, draining buffers."""
