"""IRNet pseudo-labels: the instance pseudo-mask pass (``make_ins_seg``)."""
