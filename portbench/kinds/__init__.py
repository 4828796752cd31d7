"""Traffic generators, one module per "kind" of traffic/<mix>.json."""
