"""Tools of the port: the visualization colormap and the dataset converters
(Ref-DAVIS17 to the Ref-YouTube-VOS layout, RefCOCO/+/g to COCO json)."""
