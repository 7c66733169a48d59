"""Training of the language-model stack: AdamW and the train step."""
