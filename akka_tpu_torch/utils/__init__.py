"""Port utilities: device resolution and cross-package state carry."""
