"""IRNet pseudo-labels: the CRF ir labels, IRN training and the instance
pseudo-mask pass (``make_ins_seg``)."""
