/* Declarations of the stable libzstd API subset this library calls, for
 * hosts that ship the zstd runtime (libzstd.so.1) without its development
 * header.  Every name, value and signature below is part of zstd's stable
 * ABI (zstd.h "stable API", v1.4.0+); etpu_codec.cc includes the system
 * <zstd.h> instead whenever it exists. */
#ifndef ETPU_ZSTD_DECLS_H
#define ETPU_ZSTD_DECLS_H

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct ZSTD_CCtx_s ZSTD_CCtx;
typedef enum {
  ZSTD_c_compressionLevel = 100,
  ZSTD_c_checksumFlag = 201
} ZSTD_cParameter;

#define ZSTD_CONTENTSIZE_UNKNOWN (0ULL - 1)
#define ZSTD_CONTENTSIZE_ERROR (0ULL - 2)

ZSTD_CCtx *ZSTD_createCCtx(void);
size_t ZSTD_freeCCtx(ZSTD_CCtx *cctx);
size_t ZSTD_CCtx_setParameter(ZSTD_CCtx *cctx, ZSTD_cParameter param,
                              int value);
size_t ZSTD_compressBound(size_t srcSize);
size_t ZSTD_compress2(ZSTD_CCtx *cctx, void *dst, size_t dstCapacity,
                      const void *src, size_t srcSize);
size_t ZSTD_decompress(void *dst, size_t dstCapacity, const void *src,
                       size_t compressedSize);
unsigned long long ZSTD_getFrameContentSize(const void *src, size_t srcSize);
unsigned ZSTD_isError(size_t code);

#ifdef __cplusplus
}
#endif

#endif /* ETPU_ZSTD_DECLS_H */
