"""Paper experiment drivers on the port: CNN training (with the footnote-2
QAT retraining), the Table 1 parameter-class histogram, and cached
trained models (the counterpart of ``repro.paper``)."""
