"""The benchmark's general code: finding cells, configurations, traffic
drivers and metric readers by name, making scenes from a seed, reading
traces, counting roofline work and comparing with the reference."""
