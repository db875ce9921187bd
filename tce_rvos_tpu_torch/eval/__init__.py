"""Evaluation metrics of the port: A2D/JHMDB, RefCOCO, COCO and DAVIS."""
