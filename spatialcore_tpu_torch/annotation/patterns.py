"""Ordered regex → canonical Cell Ontology term rules.

Port of ``spatialcore_tpu/annotation/patterns.py`` (pure Python, so a
copy): about 150 first-match-wins rules that collapse noisy author labels
onto canonical CL terms (granular memory / effector T subsets collapse to
their parent on purpose). Each rule matches common author-label spellings
and emits the exact lowercase CL term label of the bundled ontology index.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

# (compiled regex, canonical CL term label) — order matters, first match wins.
_RULES: List[Tuple[str, str]] = [
    # --- T lineage (granular → parent collapses on purpose) -------------
    (r"\b(t[\s\-_]?regs?|regulatory\s+t|t\s+regulatory)\b",
     "regulatory t cell"),
    (r"\btfh\b|\bfollicular\s+helper\b", "t follicular helper cell"),
    (r"\bth17\b", "t-helper 17 cell"),
    (r"\bth1\b", "t-helper 1 cell"),
    (r"\bth2\b", "t-helper 2 cell"),
    (r"\bmait\b", "mucosal invariant t cell"),
    (r"\bnkt\b|\bnatural\s+killer\s+t\b", "mature nk t cell"),
    (r"\bgamma[\s\-_]?delta\b|\bgd\s*t\b|γδ", "gamma-delta t cell"),
    (r"cd4.*(cytotoxic|ctl)", "cd4-positive, alpha-beta cytotoxic t cell"),
    (r"cd8.*t\b|\bt.*cd8", "cd8-positive, alpha-beta t cell"),
    (r"\bctls?\b|cytotoxic\s+t", "cytotoxic t cell"),
    (r"cd4.*t\b|\bt.*cd4|helper\s+t|\bt\s+helper", "cd4-positive, alpha-beta t cell"),
    (r"\b(naive|memory|effector|central|resident|exhausted|activated)[\s\-_]+t\b",
     "t cell"),
    (r"\bt[\s\-_]?(cell|cells|lymphocyte)s?\b", "t cell"),
    # --- NK / ILC --------------------------------------------------------
    (r"\bnk[\s\-_]?(cell|cells)?\b|natural\s+killer", "natural killer cell"),
    (r"\bilc1\b", "group 1 innate lymphoid cell"),
    (r"\bilc2\b", "group 2 innate lymphoid cell"),
    (r"\bilc3\b", "group 3 innate lymphoid cell"),
    (r"\bilcs?\b|innate\s+lymphoid", "innate lymphoid cell"),
    # --- B lineage --------------------------------------------------------
    (r"plasmablast", "plasmablast"),
    (r"plasma\s*(cell|cells)?\b", "plasma cell"),
    (r"(naive)[\s\-_]+b\b", "naive b cell"),
    (r"(memory)[\s\-_]+b\b", "memory b cell"),
    (r"germinal\s+center\s+b|\bgc\s+b\b", "germinal center b cell"),
    (r"follicular\s+b\b", "follicular b cell"),
    (r"marginal\s+zone", "marginal zone b cell of spleen"),
    (r"\bb[\s\-_]?(cell|cells|lymphocyte)s?\b", "b cell"),
    # --- myeloid ---------------------------------------------------------
    (r"(classical|cd14\+?)[\s\-_]+mono", "classical monocyte"),
    (r"(non[\s\-_]?classical|cd16\+?)[\s\-_]+mono", "non-classical monocyte"),
    (r"monocyte", "monocyte"),
    (r"kupffer", "kupffer cell"),
    (r"hofbauer", "hofbauer cell"),
    (r"alveolar\s+macro", "alveolar macrophage"),
    (r"\bm2[\s\-_]?(macrophage|mac|mø)",
     "alternatively activated macrophage"),
    (r"\bm1[\s\-_]?(macrophage|mac|mø)", "inflammatory macrophage"),
    (r"(tam|tissue[\s\-_]?resident)?[\s\-_]*macrophage", "macrophage"),
    (r"\bpdc\b|plasmacytoid", "plasmacytoid dendritic cell"),
    (r"\bcdc[12]?\b|conventional\s+dendritic|myeloid\s+dendritic",
     "conventional dendritic cell"),
    (r"langerhans", "langerhans cell"),
    (r"dendritic", "dendritic cell"),
    (r"neutrophil", "neutrophil"),
    (r"eosinophil", "eosinophil"),
    (r"basophil", "basophil"),
    (r"mast\s*(cell|cells)?", "mast cell"),
    (r"myeloid", "myeloid cell"),
    # --- erythroid / megakaryocytic / stem --------------------------------
    (r"erythro(cyte|id)|red\s+blood|\brbcs?\b", "erythrocyte"),
    (r"platelet|thrombocyte", "platelet"),
    (r"megakaryocyte", "megakaryocyte"),
    (r"\bhsc\b|hematopoietic\s+stem", "hematopoietic stem cell"),
    (r"\bmsc\b|mesenchymal\s+stem", "mesenchymal stem cell"),
    (r"erythroblast|proerythroblast|erythroid\s+progenitor",
     "erythroid progenitor cell"),
    (r"thymocyte", "thymocyte"),
    (r"satellite\s+cell", "skeletal muscle satellite cell"),
    (r"stem\s+cell", "stem cell"),
    # --- stromal / vascular ------------------------------------------------
    (r"lymphatic\s+(endo|ecs?\b)", "endothelial cell of lymphatic vessel"),
    (r"(vascular|blood|arterial|venous|capillary)?[\s\-_]*endothel",
     "endothelial cell"),
    (r"\b(arterial|venous|capillary|vascular)\s+ecs?\b", "endothelial cell"),
    (r"myofibroblast", "myofibroblast cell"),
    (r"\bcafs?\b|cancer[\s\-_]?associated\s+fibro", "fibroblast"),
    (r"fibroblast", "fibroblast"),
    (r"smooth\s+muscle|\bsmc\b", "smooth muscle cell"),
    (r"pericyte|mural", "pericyte"),
    (r"cardiomyocyte|cardiac\s+muscle", "cardiac muscle cell"),
    (r"skeletal\s+muscle|myocyte", "skeletal muscle fiber"),
    (r"adipocyte|fat\s+cell", "adipocyte"),
    (r"chondrocyte", "chondrocyte"),
    (r"osteoblast", "osteoblast"),
    (r"osteoclast", "osteoclast"),
    (r"mesothel", "mesothelial cell"),
    # --- epithelial ---------------------------------------------------------
    (r"\bat1\b|type\s*i\s+(pneumocyte|alveolar)|alveolar\s+type\s*1",
     "type i pneumocyte"),
    (r"\bat2\b|type\s*ii\s+(pneumocyte|alveolar)|alveolar\s+type\s*2",
     "type ii pneumocyte"),
    (r"club\s*(cell)?|clara", "club cell"),
    (r"goblet", "goblet cell"),
    (r"ciliated", "ciliated cell"),
    (r"basal\s*(cell)?", "basal cell"),
    (r"secretory", "secretory cell"),
    (r"enterocyte", "enterocyte"),
    (r"paneth", "paneth cell"),
    (r"tuft|brush\s+cell", "brush cell"),
    (r"enteroendocrine", "enteroendocrine cell"),
    (r"hepatocyte", "hepatocyte"),
    (r"cholangiocyte|biliary\s+epithel", "cholangiocyte"),
    (r"keratinocyte", "keratinocyte"),
    (r"melanocyte", "melanocyte"),
    (r"acinar", "acinar cell"),
    (r"ductal", "duct epithelial cell"),
    (r"beta\s+cell|β\s*cell", "type b pancreatic cell"),
    (r"alpha\s+cell|α\s*cell", "pancreatic a cell"),
    (r"delta\s+cell|δ\s*cell", "pancreatic d cell"),
    (r"\bpp\s+cell|pancreatic\s+polypeptide", "pancreatic pp cell"),
    (r"luminal\s+epithel", "luminal epithelial cell of mammary gland"),
    # kidney
    (r"distal\s+(convoluted\s+)?tubule", "epithelial cell of distal tubule"),
    (r"collecting\s+duct", "kidney collecting duct cell"),
    (r"loop\s+of\s+henle|thick\s+ascending", "kidney loop of henle epithelial cell"),
    (r"mesangial", "mesangial cell"),
    (r"intercalated\s+cell", "renal intercalated cell"),
    # stomach / airway / bladder
    (r"parietal\s+cell", "parietal cell"),
    (r"urothel", "urothelial cell"),
    (r"ionocyte", "ionocyte"),
    # thyroid / placenta / gonads
    (r"thyrocyte|thyroid\s+follicular", "thyroid follicular cell"),
    (r"syncytiotrophoblast", "syncytiotrophoblast cell"),
    (r"trophoblast", "trophoblast cell"),
    (r"decidual", "decidual cell"),
    (r"granulosa", "granulosa cell"),
    (r"theca", "theca cell"),
    (r"leydig", "leydig cell"),
    (r"sertoli", "sertoli cell"),
    (r"spermatogoni", "spermatogonium"),
    (r"oocyte", "oocyte"),
    # eye
    (r"retinal\s+pigment\s+epithel|\brpe\b", "retinal pigment epithelial cell"),
    (r"photoreceptor", "photoreceptor cell"),
    (r"epithel", "epithelial cell"),
    # --- neural ---------------------------------------------------------------
    (r"astrocyte", "astrocyte"),
    (r"oligodendrocyte\s+precursor|\bopc\b",
     "oligodendrocyte precursor cell"),
    (r"oligodendrocyte", "oligodendrocyte"),
    (r"microglia", "microglial cell"),
    (r"ependymal", "ependymal cell"),
    (r"purkinje", "purkinje cell"),
    (r"schwann", "schwann cell"),
    (r"(inhibitory|excitatory|gabaergic|glutamatergic)?[\s\-_]*neuron",
     "neuron"),
    (r"neural|glia\b|glial", "glial cell"),
    # --- tumor / generic -------------------------------------------------------
    (r"tumou?r|malignant|cancer\s+cell|carcinoma|neoplastic",
     "malignant cell"),
    (r"ionocyte", "ionocyte"),
    (r"stellate", "hepatic stellate cell"),
    (r"podocyte", "podocyte"),
    (r"proximal\s+tubule", "epithelial cell of proximal tubule"),
    (r"stromal", "stromal cell"),
    (r"progenitor", "progenitor cell"),
    (r"lymphocyte", "lymphocyte"),
    (r"leukocyte|immune\s+cell", "leukocyte"),
]

CELL_TYPE_PATTERNS: List[Tuple[re.Pattern, str]] = [
    (re.compile(rx, re.IGNORECASE), term) for rx, term in _RULES
]


def get_canonical_term(label: str) -> Optional[str]:
    """First-match-wins canonicalization of an author label, or None."""
    text = str(label).strip()
    for pattern, term in CELL_TYPE_PATTERNS:
        if pattern.search(text):
            return term
    return None
