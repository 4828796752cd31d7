"""Operations and bytes that a layer needs at a cell's shapes, counted from
the shapes and the episodes' lengths: each input read once, each output
written once, attention over the real (query, key) pairs only.  A kernel
that fuses, splits or recomputes leaves these counts as they are."""
