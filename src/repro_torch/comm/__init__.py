"""Wire plumbing (``wire``) and channels (``channel``)."""
