from .synth import Dataset, knn_rect_queries, make_airline, make_generic_fd, make_osm

__all__ = ["Dataset", "make_airline", "make_osm", "make_generic_fd", "knn_rect_queries"]
