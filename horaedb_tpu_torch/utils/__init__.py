"""Cross-cutting components (ref: src/components/*)."""
