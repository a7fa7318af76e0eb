"""Software renderer: cull, transform, tiled visibility walk, deferred
shade."""
