"""Per-layer metrics, one reader each, found by name. A reader may have
``install(ctx)``, run once before a traced window, and has ``read(ctx)``,
run after it; it returns a number, or None when it found nothing to read
(the metric is then left out of the line)."""
