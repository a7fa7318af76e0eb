"""Entity-component helpers: the transform hierarchy."""
