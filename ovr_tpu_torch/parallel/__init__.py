"""Multi-device rendering and training over `torch.distributed` ranks:
`mesh` (the rank grid and its collectives), `tiles` (screen-row bands,
the replicated train step), `bricks` (Z-slab volumes, ring compositing,
the bricked train step) and `multihost` (jobs of several processes)."""
